"""What the per-layer readers share: the program's own kernel names (read
from its CUDA and Triton sources, so a kernel a later change adds is the
port's own too), and device time a step or a request of the traced
sub-window."""

import functools
import re
from pathlib import Path

from . import stats

PORT = Path(__file__).resolve().parents[2] / "neural_jacobian_field_torch"


@functools.lru_cache(maxsize=None)
def port_kernel_names() -> frozenset:
    """Names of the port's hand-written kernels: CUDA `__global__` functions
    and Triton `@triton.jit` functions in its sources."""
    names = set()
    for src in list(PORT.rglob("*.cu")) + list(PORT.rglob("*.cuh")):
        text = src.read_text(errors="replace")
        names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?"
                                r"(\w+)\s*\(", text))
    for src in PORT.rglob("*.py"):
        text = src.read_text(errors="replace")
        names.update(re.findall(r"@triton\.jit[^\n]*\n\s*def\s+(\w+)", text))
    return frozenset(names)


def is_port_kernel(name: str) -> bool:
    return any(re.search(rf"\b{n}\b", name) for n in port_kernel_names())


def ms_per_unit(trace, seconds: float) -> float:
    return 1e3 * seconds / trace.units


def torch_kernels_ms(out):
    """Device ms a unit in kernels that are not the port's own."""
    if out.trace is None:
        return None
    s = sum(t for n, t in out.trace.kernels_s.items() if not is_port_kernel(n))
    return ms_per_unit(out.trace, s)


def device_idle_pct(out):
    if out.trace is None:
        return None
    return stats.idle_share(out.trace.busy_s, out.trace.wall_s)


def mfu_pct(out, peak_flops: float):
    """The window's model operations over its time at the card's peak."""
    c = out.context
    if not c.get("calls") or not c.get("window_s"):
        return None
    return 100.0 * c["calls"] * c["call_flops"] / (c["window_s"] * peak_flops)


def share_of_bound(out, bound_s_per_unit: float, patterns):
    """The least time of a layer's work a unit over its kernels' device
    time a unit, in percent; None where those kernels did not run."""
    if out.trace is None:
        return None
    took = out.trace.seconds_matching(patterns) / out.trace.units
    return None if took <= 0 else 100.0 * bound_s_per_unit / took
