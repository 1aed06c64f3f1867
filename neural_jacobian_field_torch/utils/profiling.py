"""Spans, device marks and counters of the port, and the exports that read
them (PyTorch counterpart of utils/profiling.py).

- Host spans (`span`): a named stretch of the host's work, with its parent
  and the call it belongs to (an entry point's span, `call=True`, starts a
  call: a train call, an encode, a solve). A span has two sinks: a
  `record_function` range, so that it lands in a running torch.profiler
  trace on the profiler's own clock (and names the device's idle gaps that
  start inside it), and this module's registry (`host_spans`). It is
  recorded only while a profiler records or a `collect()` block is open,
  and otherwise costs one flag check; a span opened with `always=True` (a
  program's capture, which is rare) is recorded in any case.
- Device marks (`program`, `layer`, `mark`): the layer boundaries inside a
  program's device work. A mark is a transition: the device time from it to
  the next mark belongs to the innermost layer open at it, and the time no
  layer holds (a program's own work, a step's) is `unattributed`. On the
  card a mark is a one-thread kernel that writes the device's global timer
  into a slot of the program's buffer (csrc/mark.cu): captured with the
  program, it is stamped again by every replay, with no host work. On the
  CPU a mark reads the host clock after the work (execution there is
  synchronous). Backward time goes to the same layers: `layer.output` puts
  an identity autograd.Function on a layer's outputs whose backward marks
  the layer's entry once the gradients of all of them have arrived (the
  next layer's output, or the end of the backward, closes it). The
  registry keeps each program's marks of its last run (a replay, or an
  eager call), so that they outlive the program: `device_spans()` reads
  them after a synchronize.
- Counters per program (`counters()`): `captures` and `replays`, and what
  its body did in its last run (the run a capture bakes into every replay,
  or the last eager one): `composites`, the Jacobian composites
  (`composite`) it formed, `pixel_gathers`, the per-sample pyramid
  lookups (`pixel_gathers`: points x levels) it made, and
  `attn_fused_points`, the points x layers its Jacobian transformer ran
  through the fused layer (`attn_fused_points`).
- `trace`: torch.profiler around a block, written as a Chrome trace with
  the layers of each traced program launch on the device's timeline;
  `device_idle_share`: the device's idle share as the profiler sees it.

`NJF_SPANS=0` in the environment, read once at import, turns spans and
marks into no-ops (the counters still count).
"""

import collections
import contextlib
import dataclasses
import json
import os
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import torch

ENABLED = os.environ.get("NJF_SPANS", "1") != "0"
# the layers a mark can name (PERF.md's layer map); "step" opens each step of
# a train program, and its own time is unattributed like the program's
LAYERS = ("encoder", "features", "sampler", "field", "decoder", "render", "loss", "optimizer")
UNATTRIBUTED = "unattributed"
# time marked as one of these is shared among the layers it names in the
# proportion the same run's marked time gives them (a solve marks its
# phases on some iterations only, and the rest as "iterations")
SHARED = {"iterations": ("render", "loss", "optimizer")}
# time marked as one of these is the named layer's, but is left out of the
# proportions SHARED time is split by (a part of a layer that runs once a
# program, not once an iteration: the solve's composite)
PARTS = {"composite": "render"}
SLOTS = 8192  # marks a program's run can hold on the card
MAX_SPANS = 1 << 18  # host spans kept until clear()
MAX_PROGRAMS = 256  # program records kept (the oldest dropped first)

_profiling = torch.autograd._profiler_enabled


@dataclasses.dataclass
class Span:
    name: str
    start_ns: int  # host clock (time.perf_counter_ns)
    end_ns: Optional[int]  # None while open
    parent: int  # index in host_spans() of the enclosing span, -1 for none
    call: int  # the call it belongs to, 0 outside any
    attrs: dict

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _Run:
    """One run of a program's device work: its marks' labels (the layer path
    and step at each) and their times (slots of a device buffer on the card,
    the host clock on the CPU)."""

    def __init__(self, device: torch.device, slots: Optional[torch.Tensor]):
        self.cuda = device.type == "cuda"
        self.slots = slots
        self.labels = []  # (layer path, step) per mark
        self.host_ns = []
        self.path = ()
        self.step = -1
        self.dropped = 0

    def mark(self, path: tuple, step: Optional[int] = None, stream=None) -> None:
        i = len(self.labels)
        if self.cuda:
            if i >= self.slots.numel():
                self.dropped += 1
                return
            _launch_mark(self.slots, i, stream)
        else:
            self.host_ns.append(time.perf_counter_ns())
        self.labels.append((path, self.step if step is None else step))

    def times_ns(self) -> List[int]:
        if self.cuda:
            return self.slots[:len(self.labels)].tolist()
        return list(self.host_ns)


@dataclasses.dataclass
class _Program:
    pid: int
    name: str
    captures: int = 0
    replays: int = 0
    composites: int = 0  # formed by its body in its last run
    pixel_gathers: int = 0  # per-sample pyramid lookups of its body's last run
    attn_fused_points: int = 0  # points x layers of the fused transformer layer, last run
    run: Optional[_Run] = None  # the run whose marks the last run stamped
    stamped: bool = False  # a replay (or an eager run) has written them
    sequence: int = 0  # registry-wide order of the last run
    call: int = 0  # the call of the last run


class _Registry:
    def __init__(self):
        self.spans: List[Span] = []
        self.programs: "collections.OrderedDict[int, _Program]" = collections.OrderedDict()
        self.collecting = 0
        self.calls = 0
        self.ids = 0
        self.sequence = 0


class _Local(threading.local):
    def __init__(self):
        self.stack = []  # open host spans: (index, call)
        self.runs = []  # open program runs
        self.bodies = []  # the body counters of each open program run


_REG = _Registry()
_LOCAL = _Local()
_MARK_FN = None


def _launch_mark(slots: torch.Tensor, i: int, stream=None) -> None:
    global _MARK_FN
    if _MARK_FN is None:
        from ..ops.kernels.build import load_kernels

        _MARK_FN = load_kernels().lib.njf_mark
    handle = (stream.cuda_stream if stream is not None
              else torch._C._cuda_getCurrentRawStream(slots.device.index))
    err = _MARK_FN(slots.data_ptr() + 8 * i, handle)
    if err:
        raise RuntimeError(f"njf_mark: CUDA error {err} at launch")


# ------------------------------------------------------------ host spans

class _NullSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _HostSpan:
    __slots__ = ("name", "call", "attrs", "index", "range")

    def __init__(self, name: str, call: bool, attrs: dict):
        self.name, self.call, self.attrs = name, call, attrs
        self.index, self.range = -1, None

    def __enter__(self):
        if _profiling():
            self.range = torch.autograd.profiler.record_function(self.name)
            self.range.__enter__()
        stack = _LOCAL.stack
        parent, call = stack[-1] if stack else (-1, 0)
        if self.call:
            _REG.calls += 1
            call = _REG.calls
        if len(_REG.spans) < MAX_SPANS:
            self.index = len(_REG.spans)
            _REG.spans.append(Span(self.name, time.perf_counter_ns(), None, parent, call,
                                   self.attrs))
            stack.append((self.index, call))
        return self

    def __exit__(self, *exc):
        if self.index >= 0:
            spans, stack = _REG.spans, _LOCAL.stack
            if self.index < len(spans) and spans[self.index].name == self.name:
                spans[self.index].end_ns = time.perf_counter_ns()
            if stack and stack[-1][0] == self.index:
                stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str, *, call: bool = False, always: bool = False, **attrs):
    """A host span around a block (a context manager): recorded while a
    profiler records or a collect() block is open (or, with `always`, in any
    case); `call` starts a new call identifier, which the spans inside it
    carry; `attrs` are kept with it."""
    if not (ENABLED and (always or _REG.collecting or _profiling())):
        return _NULL
    return _HostSpan(name, call, attrs)


@contextlib.contextmanager
def collect() -> Iterator[None]:
    """Record host spans inside the block without a profiler."""
    _REG.collecting += 1
    try:
        yield
    finally:
        _REG.collecting -= 1


def host_spans(name: Optional[str] = None) -> List[Span]:
    """The host spans recorded so far (all, or those named `name`), in the
    order they opened; a span's `parent` indexes this whole list."""
    return [s for s in _REG.spans if name is None or s.name == name]


def clear() -> None:
    """Drop the recorded host spans (the programs' marks and counters
    stay)."""
    _REG.spans.clear()
    _LOCAL.stack.clear()


# ------------------------------------------------------------ programs

def new_program(name: str) -> int:
    """Register a program (a captured function, or the eager runs of one);
    returns its identifier."""
    _REG.ids += 1
    _REG.programs[_REG.ids] = _Program(_REG.ids, name)
    while len(_REG.programs) > MAX_PROGRAMS:
        _REG.programs.popitem(last=False)
    return _REG.ids


def _current_call() -> int:
    stack = _LOCAL.stack
    return stack[-1][1] if stack else 0


def captured(pid: int) -> None:
    """Count a capture of program `pid`; its marks await a replay."""
    p = _REG.programs.get(pid)
    if p is not None:
        p.captures += 1
        p.stamped = False


def replayed(pid: int) -> None:
    """Count a replay of program `pid`, which stamps its captured marks."""
    p = _REG.programs.get(pid)
    if p is not None:
        p.replays += 1
        _ran(p)


def _ran(p: _Program) -> None:
    _REG.sequence += 1
    p.stamped, p.sequence, p.call = p.run is not None, _REG.sequence, _current_call()


def mark_slots(device: torch.device) -> Optional[torch.Tensor]:
    """A program's mark buffer on a card (None elsewhere, or with marks off).
    The program that captures marks into it holds it as long as its graph."""
    if not ENABLED or device.type != "cuda":
        return None
    return torch.zeros(SLOTS, dtype=torch.int64, device=device)


@contextlib.contextmanager
def program(pid: int, device: torch.device, slots: Optional[torch.Tensor] = None,
            eager: bool = False) -> Iterator[None]:
    """One run of program `pid`'s device work on `device`: marks its start
    and end and collects the marks of the layers inside; the run becomes the
    program's (the one a capture bakes in, or, with `eager`, the last
    run)."""
    p = _REG.programs.get(pid)
    if p is None:
        yield
        return
    run = _Run(device, slots if slots is not None else mark_slots(device)) if ENABLED else None
    _LOCAL.bodies.append({"composites": 0, "pixel_gathers": 0, "attn_fused_points": 0})
    if run is not None:
        _LOCAL.runs.append(run)
        run.mark(())
    try:
        yield
    finally:
        body = _LOCAL.bodies.pop()
        p.composites, p.pixel_gathers = body["composites"], body["pixel_gathers"]
        p.attn_fused_points = body["attn_fused_points"]
        if run is not None:
            run.mark(())
            _LOCAL.runs.pop()
            p.run = run
            if eager:
                _ran(p)


def composite() -> None:
    """Count a Jacobian composite formed by the program run open (outside
    any, nothing)."""
    if _LOCAL.bodies:
        _LOCAL.bodies[-1]["composites"] += 1


def pixel_gathers(n: int) -> None:
    """Count `n` per-sample pyramid lookups (points x levels) made by the
    program run open (outside any, nothing)."""
    if _LOCAL.bodies:
        _LOCAL.bodies[-1]["pixel_gathers"] += n


def attn_fused_points(n: int) -> None:
    """Count `n` points run through one fused Jacobian-transformer layer
    (ops/kernels/attn_layer.py) by the program run open (outside any,
    nothing)."""
    if _LOCAL.bodies:
        _LOCAL.bodies[-1]["attn_fused_points"] += n


def counters() -> Dict[str, dict]:
    """Captures, replays, composites, pixel gathers and fused attention
    points by program ("<name>#<id>")."""
    return {f"{p.name}#{p.pid}": {"captures": p.captures, "replays": p.replays,
                                  "composites": p.composites,
                                  "pixel_gathers": p.pixel_gathers,
                                  "attn_fused_points": p.attn_fused_points}
            for p in _REG.programs.values()}


# ------------------------------------------------------------ layers

class _Mark(torch.autograd.Function):
    """Identity on its tensors; its backward records a mark (a layer's
    entry) on the stream the forward ran on."""

    @staticmethod
    def forward(ctx, run, path, step, *xs):
        ctx.run, ctx.path, ctx.step = run, path, step
        ctx.stream = torch.cuda.current_stream(xs[0].device) if run.cuda else None
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.run.mark(ctx.path, ctx.step, ctx.stream)
        return (None, None, None, *grads)


def _collect(obj, out: list) -> None:
    if isinstance(obj, torch.Tensor):
        if obj.requires_grad:
            out.append(obj)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _collect(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _collect(x, out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _collect(getattr(obj, f.name), out)


def _rebuild(obj, it):
    if isinstance(obj, torch.Tensor):
        return next(it) if obj.requires_grad else obj
    if isinstance(obj, tuple):
        items = [_rebuild(x, it) for x in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else type(obj)(items)
    if isinstance(obj, list):
        return [_rebuild(x, it) for x in obj]
    if isinstance(obj, dict):
        return type(obj)((k, _rebuild(v, it)) for k, v in obj.items())
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _rebuild(getattr(obj, f.name), it)
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


class layer:
    """A layer of a program's device work (one of LAYERS, or "step"): a
    context manager whose entry marks the layer and whose exit marks the
    return to its parent (with `exit_mark=False` the next mark closes it);
    `output(x)` routes the gradients of the layer's outputs (tensors, or
    tuples, lists, dicts and dataclasses of them) through a mark of its
    backward. Outside a program's run it marks nothing; with `on=False` it
    does nothing at all. While host spans are recorded it is one too
    ("njf.<name>")."""

    __slots__ = ("name", "exit_mark", "on", "run", "parent", "path", "step", "host")

    def __init__(self, name: str, exit_mark: bool = True, on: bool = True):
        self.name, self.exit_mark, self.on = name, exit_mark, on and ENABLED
        self.run = self.host = None

    def __enter__(self):
        if not self.on:
            return self
        runs = _LOCAL.runs
        if runs:
            run = self.run = runs[-1]
            if self.name == "step":
                run.step += 1
            self.parent, self.step = run.path, run.step
            self.path = run.path + (self.name,)
            run.path = self.path
            run.mark(self.path)
        self.host = span("njf." + self.name)
        self.host.__enter__()
        return self

    def __exit__(self, *exc):
        if self.host is not None:
            self.host.__exit__(*exc)
        run = self.run
        if run is not None:
            run.path = self.parent
            if self.exit_mark:
                run.mark(self.parent)
        return False

    def output(self, obj):
        """obj, its gradients' arrival marking this layer's backward."""
        if self.run is None or not torch.is_grad_enabled():
            return obj
        found = []
        _collect(obj, found)
        if not found:
            return obj
        return _rebuild(obj, iter(_Mark.apply(self.run, self.path, self.step, *found)))


def mark(name: str) -> None:
    """A transition inside the current run to `name`, a child of the layer
    open (it holds the time until the next mark)."""
    runs = _LOCAL.runs
    if ENABLED and runs:
        runs[-1].mark(runs[-1].path + (name,))


# ------------------------------------------------------------ reading

def _layer_of(path: tuple) -> str:
    return path[-1] if path and path[-1] != "step" else UNATTRIBUTED


def _tree(labels, times, root: str) -> List[dict]:
    """The spans of a run: each mark's interval held by its layer path,
    contiguous intervals of a path prefix merged into one span; a span's
    self time is what no span inside it holds. Times relative to the
    run's start, in the unit of `times`."""
    t0 = times[0]
    spans = [{"name": root, "depth": 0, "parent": -1, "start": 0, "end": times[-1] - t0,
              "self": 0, "step": -1}]
    stack = [0]  # open spans by depth (indices)
    paths = [()]
    for (path, step), a, b in zip(labels, times, times[1:]):
        keep = 0
        while keep < min(len(path), len(paths) - 1) and paths[keep + 1] == path[:keep + 1]:
            keep += 1
        for i in stack[keep + 1:]:
            spans[i]["end"] = a - t0
        del stack[keep + 1:], paths[keep + 1:]
        for d in range(keep, len(path)):
            spans.append({"name": path[d], "depth": d + 1, "parent": stack[-1],
                          "start": a - t0, "end": None, "self": 0, "step": step})
            stack.append(len(spans) - 1)
            paths.append(path[:d + 1])
        spans[stack[-1]]["self"] += b - a
    for i in stack[1:]:
        spans[i]["end"] = times[-1] - t0
    return spans


def _summary(p: _Program) -> dict:
    run = p.run
    t = run.times_ns()
    labels = run.labels
    self_ns = collections.defaultdict(float)
    per_step = collections.defaultdict(lambda: collections.defaultdict(float))
    for (path, step), a, b in zip(labels, t, t[1:]):
        self_ns[_layer_of(path)] += b - a
        per_step[step][_layer_of(path)] += b - a
    estimated = 0.0
    for shared, among in SHARED.items():
        for table in [self_ns, *per_step.values()]:
            left = table.pop(shared, 0.0)
            base = sum(table.get(n, 0.0) for n in among)
            if left and base:
                for n in among:
                    table[n] += left * table.get(n, 0.0) / base
            elif left:
                table[UNATTRIBUTED] += left
            if table is self_ns:
                estimated += left
    for part, owner in PARTS.items():
        for table in [self_ns, *per_step.values()]:
            if part in table:
                table[owner] = table.get(owner, 0.0) + table.pop(part)
    steps = sorted(s for s in per_step if s >= 0)
    ms = {k: v / 1e6 for k, v in self_ns.items()}
    return {"program": p.name, "id": p.pid, "captures": p.captures, "replays": p.replays,
            "composites": p.composites, "pixel_gathers": p.pixel_gathers,
            "attn_fused_points": p.attn_fused_points, "call": p.call,
            "device_ms": (t[-1] - t[0]) / 1e6, "marks": len(t),
            "dropped": run.dropped, "steps": max(len(steps), 1), "self_ms": ms,
            "estimated_ms": estimated / 1e6,
            "per_step": [{k: v / 1e6 for k, v in per_step[s].items()} for s in steps],
            "spans": [{**s, "start": s["start"] / 1e6,
                       "end": s["end"] / 1e6, "self": s["self"] / 1e6}
                      for s in _tree(labels, t, p.name)]}


def device_spans(name: Optional[str] = None) -> List[dict]:
    """Each program's last run (all programs, or those named `name`), oldest
    first: its device ms (first mark to last), its steps, the self ms of
    each layer over the run (`self_ms`, `unattributed` for what no layer
    holds) and per step, and its span tree (ms from the run's start)."""
    progs = [p for p in _REG.programs.values()
             if p.stamped and p.run is not None and len(p.run.labels) > 1
             and (name is None or p.name == name)]
    if any(p.run.cuda for p in progs):
        torch.cuda.synchronize()
    return [_summary(p) for p in sorted(progs, key=lambda p: p.sequence)]


# ------------------------------------------------------------ exports

def _add_device_layers(path: Path, launches: List[int]) -> None:
    """Put the layers of each traced program launch on the device timeline
    of the Chrome trace at `path`: the i-th cudaGraphLaunch is the i-th
    launch span's program (`launches`: program ids in launch order), each of
    its marks the start of the layer the program's run names there, at the
    mark kernel's own time."""
    data = json.loads(path.read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    graph_launches = sorted((e for e in events if e.get("name") == "cudaGraphLaunch"
                             and e.get("ph") == "X"), key=lambda e: e["ts"])
    marks = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "kernel" and str(e.get("name", "")).startswith("njf_mark_kernel"):
            marks[e.get("args", {}).get("correlation")].append(e)
    placed = []
    for launch, pid in zip(graph_launches, launches):
        p = _REG.programs.get(pid)
        got = sorted(marks.get(launch.get("args", {}).get("correlation"), []),
                     key=lambda e: e["ts"])
        if p is None or p.run is None or len(got) != len(p.run.labels) or len(got) < 2:
            continue
        dev_pid, times = got[0]["pid"], [float(e["ts"]) for e in got]
        for s in _tree(p.run.labels, times, p.name):
            placed.append({"ph": "X", "cat": "njf_layer", "name": s["name"], "pid": dev_pid,
                           "tid": "njf layers", "ts": times[0] + s["start"],
                           "dur": s["end"] - s["start"],
                           "args": {"self_us": s["self"], "step": s["step"],
                                    "program": f"{p.name}#{p.pid}"}})
    if placed:
        events.extend(placed)
        path.write_text(json.dumps(data))


@contextlib.contextmanager
def trace(log_dir: str = "traces") -> Iterator[torch.profiler.profile]:
    """torch.profiler (host and, where there is a card, device activity)
    around a block, with host spans recorded; the trace goes to
    <log_dir>/trace.json, each program launch's layers placed on the
    device's timeline (a track "njf layers" beside its kernels)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    first = len(_REG.spans)
    with collect(), profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
    if cuda:
        launches = [s.attrs.get("program") for s in _REG.spans[first:]
                    if s.name == "njf.program.launch"]
        _add_device_layers(out / "trace.json", launches)


def device_idle_share(fn, device, log_dir: Optional[str] = None) -> dict:
    """torch.profiler around fn() (ended by a synchronize; with `log_dir`,
    through `trace`, so written to <log_dir>/trace.json too): the traced wall
    time (the first host event to the last device event), the device's busy
    time (the union of its kernel, copy and memset intervals, so overlapping
    work counts once; record_function ranges mirrored on the device timeline
    are spans, not work, and are left out) and the idle share 1 - busy /
    wall, in ms; the number of device events. Without a device event (a run
    on the CPU, or a trace the profiler delivered empty) busy is 0 and the
    idle share None: not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with (trace(log_dir) if log_dir else profile(activities=activities)) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize(device)
    events = prof.events()
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    dev_ev = sorted((e for e in events if e.device_type == DeviceType.CUDA
                     and e.name not in host_names), key=lambda e: e.time_range.start)
    host = [e for e in events if e.device_type == DeviceType.CPU]
    start = min(e.time_range.start for e in host)
    end = max([e.time_range.end for e in host] + [e.time_range.end for e in dev_ev])
    busy, last = 0.0, -float("inf")
    for e in dev_ev:
        s, t = e.time_range.start, e.time_range.end
        busy += max(0.0, t - max(s, last))
        last = max(last, t)
    wall = end - start
    return {"wall_ms": wall / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / wall if dev_ev else None, "device_events": len(dev_ev)}
