"""Profiling helpers (PyTorch counterpart of utils/profiling.py): a device
trace around a block (torch.profiler, written as a Chrome trace), named
ranges that show in it (record_function), and a step timer on CUDA events
where the work runs on a card, on the host clock otherwise."""

import contextlib
import time
from pathlib import Path
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str = "traces") -> Iterator[torch.profiler.profile]:
    """torch.profiler (host and, where there is a card, device activity)
    around a block; the trace goes to <log_dir>/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))


def annotate(name: str):
    """A named range in profiler traces."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Per-step time, skipping the first `skip` steps: `tick()` once per
    step. With `device` a CUDA device the interval is read from CUDA events
    recorded on its current stream (the device's time between ticks);
    otherwise it is the host's wall clock."""

    def __init__(self, skip: int = 2, device=None):
        self.skip = skip
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self._count = 0
        self._last = None
        self._events = []  # (start, end) pairs, read at the end
        self._total = 0.0

    def tick(self):
        if self.cuda:
            now = torch.cuda.Event(enable_timing=True)
            now.record()
            if self._last is not None and self._count > self.skip:
                self._events.append((self._last, now))
        else:
            now = time.perf_counter()
            if self._last is not None and self._count > self.skip:
                self._total += now - self._last
        self._last = now
        self._count += 1

    @property
    def mean_step_time(self) -> Optional[float]:
        """Seconds per step over the timed steps (None before there is one)."""
        if self.cuda:
            if not self._events:
                return None
            self._events[-1][1].synchronize()
            return sum(a.elapsed_time(b) for a, b in self._events) / 1e3 / len(self._events)
        steps = self._count - 1 - self.skip
        return self._total / steps if steps > 0 else None


def device_idle_share(fn, device) -> dict:
    """torch.profiler around fn() (ended by a synchronize): the traced wall
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
    with profile(activities=activities) as prof:
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
