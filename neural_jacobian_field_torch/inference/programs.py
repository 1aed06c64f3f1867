"""Captured device programs: the port's counterpart of `jax.jit` for the
serving entry points and the train steps.

In the JAX package each serving entry point is one compiled device program
(`patch_render`: one jit sweeping the chunks with `lax.map`;
`optimize_actions`: one jit over a `lax.scan`; `solve_actions_least_squares`
and the encoders: one jit each), and so is each train step variant
(training/train.py). Here a function of CUDA tensors is captured
once per input signature as a CUDA graph and replayed on every later call
with that signature, so a call costs the host one graph launch instead of
one launch per operation:

- static input buffers: a call copies its inputs into them, so no address
  baked into the graph (a kernel's pointer, a TMA tensor map) goes stale;
- static outputs in the graph's private memory pool: a call returns copies
  of them, or copies them into destinations the caller hands in, so a later
  replay never overwrites a result the caller holds;
- no garbage collection during a capture (a graph that a collection frees
  mid-capture invalidates it: `gc.collect()` runs first, then waits);
- two warm-up calls on a side stream before the capture (the allocator,
  cuBLAS and cuDNN handles, the kernels' once-per-process attributes); a
  function that updates tensors in place (`writes`: a train step's
  parameters, statistics and optimizer state) finds them after the warm-up
  and the capture as they were before;
- a private memory pool per program, or one pool shared by the programs
  of a name (`pool`), which must then never run concurrently;
- launch accounting: a capture launches nothing, so the kernel wrappers'
  counts made while capturing are taken back and added on every replay:
  `ops.kernels.launch_counts()` counts what ran;
- spans and marks (utils/profiling.py): each program is registered there
  and counts its captures and replays; a capture is a span
  (`njf.program.capture`: `njf.program.warm_up`, `njf.program.graph`,
  ended by a synchronize), and so is each part of a call (`njf.program.
  replay`: `lookup`, `copy_in`, `launch`, `accounting`, `copy_out`) while
  host spans are recorded; the function runs inside `profiling.program`,
  so the layer marks it makes are captured with it (into a mark buffer
  the program holds) and stamped by every replay.

A program is keyed by its function and static arguments (`key`), the shapes,
dtypes and devices of its inputs, and the addresses, dtypes and shapes of
what it reads in place: the parameters and buffers of every module in `key`
and the `resident` and `writes` tensors. Weights loaded in place
(`load_state_dict`) are read by the next replay; weights reassigned move,
and the program is captured again, replacing the one it supersedes. On CUDA a failed capture or
replay raises: nothing falls back to eager execution. On the CPU, and inside
`ProgramCache.eager()`, the entry points run the same Python eagerly.
"""

import contextlib
import functools
import gc
import itertools

import torch
from torch import nn

from ..utils import profiling


def _launch_state() -> dict:
    from ..ops.kernels import KERNELS

    return {name: (w.launches, getattr(w, "legacy_launches", 0))
            for name, (w, *_) in KERNELS.items()}


def _set_launches(state: dict, delta: dict | None = None) -> None:
    """Set each kernel wrapper's counts to state (plus delta)."""
    from ..ops.kernels import KERNELS

    for name, (w, *_) in KERNELS.items():
        n, legacy = state[name]
        dn, dlegacy = delta[name] if delta else (0, 0)
        w.launches = n + dn
        if hasattr(w, "legacy_launches"):
            w.legacy_launches = legacy + dlegacy


@contextlib.contextmanager
def _no_collection():
    """Python's cyclic garbage collected first, then held off: a model
    dropped earlier still holds its programs (the two refer to each other),
    and a CUDA graph freed by a collection that lands inside another graph's
    capture invalidates that capture."""
    enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class CudaGraphs:
    """The capture backend: a CUDA graph per program, in a private pool."""

    @staticmethod
    def captures(device: torch.device) -> bool:
        return device.type == "cuda"

    @staticmethod
    def warm_up(fn, inputs) -> None:
        current = torch.cuda.current_stream(inputs[0].device)
        side = torch.cuda.Stream(inputs[0].device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(2):
                fn(*inputs)
        current.wait_stream(side)

    @staticmethod
    def pool():
        return torch.cuda.graph_pool_handle()

    @staticmethod
    def capture(fn, inputs, pool=None):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            outputs = fn(*inputs)
        return graph, outputs

    @staticmethod
    def replay(graph) -> None:
        graph.replay()


class CapturedProgram:
    """fn(*inputs) captured once by `backend` for inputs shaped like
    `inputs`. fn returns a tuple: its tensors become the static outputs, any
    other element is returned as it was at capture. The `writes` tensors,
    which fn updates in place, are put back after the warm-up and the
    capture; `pool` is the backend's memory pool to capture into (None: a
    private one); `pid` is the program's identifier in utils/profiling.py
    (None: a new one, named after fn)."""

    def __init__(self, fn, inputs, backend, writes=(), pool=None, pid=None):
        self.backend = backend
        self.pid = profiling.new_program(getattr(fn, "__name__", "program")) \
            if pid is None else pid
        device = inputs[0].device
        self.inputs = tuple(t.detach().clone(memory_format=torch.contiguous_format)
                            for t in inputs)
        capture = backend.capture if pool is None else functools.partial(backend.capture,
                                                                         pool=pool)
        self.slots = profiling.mark_slots(device)  # outside the pool: it outlives the graph

        def marked(*xs):
            with profiling.program(self.pid, device, self.slots):
                return fn(*xs)

        with torch.no_grad():
            saved = [t.detach().clone() for t in writes]
        with profiling.span("njf.program.capture", always=True, program=self.pid):
            try:
                with profiling.span("njf.program.warm_up", always=True):
                    backend.warm_up(marked, self.inputs)
                before = _launch_state()
                try:
                    with profiling.span("njf.program.graph", always=True), _no_collection():
                        self._graph, outputs = capture(marked, self.inputs)
                finally:
                    after = _launch_state()
                    _set_launches(before)
            finally:
                with torch.no_grad():
                    for t, s in zip(writes, saved):
                        t.copy_(s)
            # the span ends with the capture's device work, except under CUDA's
            # sync debug mode, where nothing in a capture may wait
            if device.type == "cuda" and torch.cuda.get_sync_debug_mode() == 0:
                torch.cuda.synchronize(device)
        profiling.captured(self.pid)
        self.launches = {name: (after[name][0] - n, after[name][1] - legacy)
                         for name, (n, legacy) in before.items()}
        self.outputs = tuple(outputs)

    @torch.no_grad()
    def replay(self, *inputs):
        """Copy the inputs into the static buffers (None keeps a buffer as it
        is), replay, count the launches; returns the static outputs, which
        the next replay overwrites. Nothing is recorded for autograd."""
        with profiling.span("njf.program.copy_in"):
            for buf, t in zip(self.inputs, inputs):
                if t is not None and t is not buf:
                    buf.copy_(t)
        with profiling.span("njf.program.launch", program=self.pid):
            self.backend.replay(self._graph)
        with profiling.span("njf.program.accounting"):
            _set_launches(_launch_state(), self.launches)
            profiling.replayed(self.pid)
        return self.outputs

    @torch.no_grad()
    def __call__(self, *inputs, out=None):
        """Replay; returns copies of the outputs, or copies them into `out`
        (one destination per output) and returns it."""
        outputs = self.replay(*inputs)
        with profiling.span("njf.program.copy_out"):
            if out is None:
                return tuple(o.clone() if isinstance(o, torch.Tensor) else o for o in outputs)
            for dst, o in zip(out, outputs):
                dst.copy_(o)
        return out


def _resident(key, tensors) -> tuple:
    """Address, dtype and shape of every tensor a program reads in place:
    the parameters and buffers of the modules in `key`, then `tensors`."""
    modules = [m for m in key if isinstance(m, nn.Module)]
    params = itertools.chain.from_iterable(
        itertools.chain(m.parameters(), m.buffers()) for m in modules)
    return tuple((t.data_ptr(), t.dtype, tuple(t.shape))
                 for t in itertools.chain(params, tensors))


class ProgramCache:
    """A model's captured programs, one per (key, input signature)."""

    def __init__(self, backend=None):
        self.backend = CudaGraphs() if backend is None else backend
        self.enabled = True
        self._programs = {}  # (key, signature) -> (resident signature, program)
        self._pools = {}  # pool name -> the backend's pool
        self._ids = {}  # (key, signature) -> the program's identifier in profiling

    def _pid(self, sig, name) -> int:
        pid = self._ids.get(sig)
        if pid is None:
            pid = self._ids[sig] = profiling.new_program(name or getattr(sig[0][0], "__name__",
                                                                          "program"))
        return pid

    def captures(self, t: torch.Tensor) -> bool:
        """Whether a call on t's device runs as a captured program."""
        return self.enabled and self.backend.captures(t.device)

    @contextlib.contextmanager
    def eager(self):
        """Run the entry points eagerly on every device inside the block (the
        reference the captured programs are held against)."""
        enabled, self.enabled = self.enabled, False
        try:
            yield
        finally:
            self.enabled = enabled

    @staticmethod
    def _signature(key: tuple, inputs) -> tuple:
        return (key, tuple((tuple(t.shape), t.dtype, t.device) for t in inputs))

    def get(self, key: tuple, inputs, fn, resident=(), writes=(), pool=None,
            name=None) -> CapturedProgram:
        """The program of `key` for inputs like `inputs`; fn (called as
        fn(*inputs)) is captured only where no program matches. fn reads
        `resident` and reads and updates `writes` in place; `pool` names the
        memory pool it shares with the other programs of that name; `name`
        names the program in utils/profiling.py (None: key[0]'s name)."""
        with profiling.span("njf.program.lookup"):
            sig = self._signature(key, inputs)
            res = _resident(key, [*resident, *writes])
            entry = self._programs.get(sig)
        if entry is None or entry[0] != res:
            self._programs.pop(sig, None)  # free the superseded program's pool first
            if pool is not None and pool not in self._pools:
                self._pools[pool] = self.backend.pool()
            entry = (res, CapturedProgram(fn, inputs, self.backend, writes,
                                          self._pools.get(pool), self._pid(sig, name)))
            self._programs[sig] = entry
        return entry[1]

    def run(self, key: tuple, inputs, fn, resident=(), writes=(), pool=None, name=None):
        """fn(*inputs): replayed from its program (copies of the outputs)
        where this cache captures inputs[0]'s device, else run eagerly (its
        marks then the program's last run)."""
        if self.captures(inputs[0]):
            with profiling.span("njf.program.replay"):
                return self.get(key, inputs, fn, resident, writes, pool, name)(*inputs)
        pid = self._pid(self._signature(key, inputs), name)
        with profiling.program(pid, inputs[0].device, eager=True):
            return fn(*inputs)

    def __len__(self) -> int:
        return len(self._programs)

    def __iter__(self):
        """The programs held."""
        return (program for _, program in self._programs.values())
