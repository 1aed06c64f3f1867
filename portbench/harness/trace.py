"""A short steady sub-window under torch.profiler, reduced to what the
per-layer readers take: each device kernel's time by name, the device's
busy time (the union of its intervals, so overlapping work counts once),
the traced wall time, and the longest idle gaps of the device by what the
host was doing."""

import collections
import math
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from .stats import union_length


@dataclass
class Trace:
    kernels_s: Dict[str, float]  # device seconds by kernel name
    busy_s: float
    wall_s: float
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # (host op, idle seconds)
    units: int = 0  # steps or requests inside the trace

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels_s.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": self.gaps[:top]}

    def seconds_matching(self, patterns) -> float:
        """Device seconds of the kernels whose name matches any pattern."""
        import re

        rx = [re.compile(p) for p in patterns]
        return sum(s for n, s in self.kernels_s.items() if any(r.search(n) for r in rx))


def _gaps(dev, cpu, named: int = 64) -> List[Tuple[str, float]]:
    """Idle stretches between device intervals: the `named` longest, each
    named by the innermost host op running when it began ("host idle" where
    none), summed by name, longest first."""
    gaps, end = [], None
    for s, t, _ in dev:
        if end is not None and s > end:
            gaps.append((s - end, end))
        end = t if end is None else max(end, t)
    merged = collections.defaultdict(float)
    for length, at in sorted(gaps, reverse=True)[:named]:
        host = [c for c in cpu if c[0] <= at < c[1]]
        name = min(host, key=lambda c: c[1] - c[0])[2] if host else "host idle"
        merged[name] += length / 1e6
    return sorted(([n, s] for n, s in merged.items()), key=lambda kv: -kv[1])


def profile(fn, units: int) -> Trace:
    """fn() under torch.profiler, ended by a synchronize; `units` is the
    count of steps or requests fn runs. Raises if the profiler saw no
    device activity in three tries."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for attempt in range(3):
        if attempt:
            time.sleep(0.5)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        events = prof.events()
        host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
        dev = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                      if e.device_type == DeviceType.CUDA and e.name not in host_names))
        if dev:
            break
    else:
        raise RuntimeError("torch.profiler recorded no device activity")
    cpu = [(e.time_range.start, e.time_range.end, e.name) for e in events
           if e.device_type == DeviceType.CPU]
    start = min(c[0] for c in cpu)
    end = max(t for _, t, _ in dev)
    kernels = collections.defaultdict(float)
    for s, t, name in dev:
        kernels[name] += (t - s) / 1e6
    busy = union_length([(s, t) for s, t, _ in dev]) / 1e6
    wall = (end - start) / 1e6
    if not (busy > 0 and wall > 0 and math.isfinite(wall)):
        raise RuntimeError(f"trace without device time: busy {busy}, wall {wall}")
    return Trace(dict(kernels), busy, wall, _gaps(dev, cpu), units)
