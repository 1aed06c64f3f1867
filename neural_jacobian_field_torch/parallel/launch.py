"""Ranks of a data-parallel group as fresh processes, for the dry run, the
tests and chip_smoke (a user's run starts its ranks with torchrun).

`start(fn, n, args)` spawns n processes (the spawn start method: nothing of
the parent's state is forked) and runs fn(rank, n, init_method, *args) in
each; init_method is a file:// rendezvous under a fresh directory, so
parallel runs never collide on a port. Each rank's return value comes back
through a file (torch.save: tensors, numbers, dicts of them). A rank that
raises, dies or outlives the time limit fails the whole call: the others are
killed, and the error names the rank and carries its traceback.
"""

import multiprocessing
import shutil
import tempfile
import time
import traceback
from pathlib import Path

import torch


def _run(fn, rank, n, init_method, out, threads, args):
    try:
        if threads:
            torch.set_num_threads(threads)
        result = fn(rank, n, init_method, *args)
        torch.save(result, out)
    except BaseException:
        Path(f"{out}.err").write_text(traceback.format_exc())
        raise SystemExit(1)


class Ranks:
    """Running ranks; `join()` waits for them and returns their results."""

    def __init__(self, fn, n: int, args=(), timeout_s: float = 600.0, threads: int = 0):
        self.dir = Path(tempfile.mkdtemp(prefix="njf_ranks_"))
        self.timeout_s = timeout_s
        init = f"file://{self.dir / 'rendezvous'}"
        ctx = multiprocessing.get_context("spawn")
        self.outs = [self.dir / f"rank{r}.pt" for r in range(n)]
        self.procs = [ctx.Process(target=_run, args=(fn, r, n, init, str(self.outs[r]), threads,
                                                     tuple(args)), daemon=True)
                      for r in range(n)]
        self.t0 = time.monotonic()
        for p in self.procs:
            p.start()

    def _stop(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(5.0)

    def join(self) -> list:
        try:
            while any(p.is_alive() for p in self.procs):
                failed = [r for r, p in enumerate(self.procs)
                          if not p.is_alive() and p.exitcode != 0]
                if failed:
                    break
                if time.monotonic() - self.t0 > self.timeout_s:
                    raise RuntimeError(f"ranks still running after {self.timeout_s:.0f} s "
                                       "(killed)")
                time.sleep(0.05)
            for p in self.procs:
                p.join(1.0)
            failed = [r for r, p in enumerate(self.procs) if p.exitcode != 0]
            if failed:
                r = failed[0]
                err = Path(f"{self.outs[r]}.err")
                why = err.read_text() if err.exists() else f"exit code {self.procs[r].exitcode}"
                raise RuntimeError(f"rank {r} of {len(self.procs)} failed:\n{why}")
            return [torch.load(o, weights_only=False) for o in self.outs]
        finally:
            self._stop()
            shutil.rmtree(self.dir, ignore_errors=True)


def start(fn, n: int, args=(), timeout_s: float = 600.0, threads: int = 0) -> Ranks:
    """Spawn n ranks of fn(rank, n, init_method, *args) (fn importable by
    name); `threads` > 0 sets each rank's torch threads."""
    return Ranks(fn, n, args, timeout_s, threads)


def spawn(fn, n: int, args=(), timeout_s: float = 600.0, threads: int = 0) -> list:
    """start(...).join(): the ranks' results in rank order."""
    return start(fn, n, args, timeout_s, threads).join()


def rank_device(rank: int, device: str) -> torch.device:
    """A rank's device: the CPU, or card `rank` of those visible ("cuda"),
    or the one card named ("cuda:0": ranks sharing it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev

