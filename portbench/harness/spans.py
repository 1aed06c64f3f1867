"""What the readers of the program's own spans and marks share
(neural_jacobian_field_torch/utils/profiling.py): the device ms a step of a
layer family, read from the marks of each program's last replay, the host
ms a step inside the entry points' spans, and the seconds of the captures.

Device readings are per step of the program's last replay: in a train cell
the call checked after the window (the same program as the window's, on
another pool entry), in the control cell the last traced request (its
encode and its solve). Host readings come from the spans recorded while the
profiler ran (the traced sub-window). A program without the registry, or
whose registry holds nothing for the cell, gives None."""

# the programs of a cell, by its traffic's kind, in the order a unit runs them
PROGRAMS = {"train_program": ("train",), "control_loop": ("encode", "solve")}
# the entry points' spans a unit opens; the first counts the units (its
# "steps", or one a span)
ENTRIES = {"train_program": ("njf.train.call",), "control_loop": ("njf.encode", "njf.solve")}


def _registry():
    try:
        from neural_jacobian_field_torch.utils import profiling
    except ImportError:
        return None
    return profiling


def layers_ms(cell, layers):
    """Device ms a unit (a step, or a request) of the layers' self time over
    the last replay of each of the cell's programs (forward and backward)."""
    read = getattr(_registry(), "device_spans", None)
    names = PROGRAMS.get(cell.kind)
    if read is None or not names:
        return None
    runs = read()
    total = 0.0
    for name in names:
        mine = [r for r in runs if r["program"] == name]
        if not mine:
            return None
        last = mine[-1]
        total += sum(last["self_ms"].get(n, 0.0) for n in layers) / last["steps"]
    return total


def entry_host_ms(cell):
    """Host ms a unit inside the cell's entry-point spans."""
    read = getattr(_registry(), "host_spans", None)
    names = ENTRIES.get(cell.kind)
    if read is None or not names:
        return None
    spans = [s for s in read() if s.name in names and s.end_ns is not None]
    units = sum(s.attrs.get("steps", 1) for s in spans if s.name == names[0])
    if not units:
        return None
    return sum((s.end_ns - s.start_ns) / 1e6 for s in spans) / units


def capture_s():
    """Seconds in the programs' captures (warm-up calls, capture, the
    synchronize that ends them)."""
    read = getattr(_registry(), "host_spans", None)
    if read is None:
        return None
    spans = [s for s in read("njf.program.capture") if s.end_ns is not None]
    return sum((s.end_ns - s.start_ns) / 1e9 for s in spans) if spans else None
