"""Stage host batches on the card ahead of the train loop (PyTorch
counterpart of parallel/mesh.py:DevicePrefetcher, one card).

A daemon thread takes RawBatches from a host iterator and copies each to
the device on a side stream (asynchronous from page-locked memory, see
data/loader.py's pin_memory), then records an event; `next()` makes the
consumer's stream wait on that event and marks the tensors as used by it,
so the allocator does not hand their memory back before the consumer's
work on them is done. At most `depth` staged batches wait. A stream of
`stack_batches` results (a leading [K] substep axis) needs no mode of its
own: on one card it is copied as any other batch. With a `mesh`
(parallel/mesh.py) the thread first keeps this rank's rows of each batch
(`shard_batch`), as the JAX `DevicePrefetcher(host_iter, mesh)` does (a
stream of stacks is sharded by its maker, `shard_stacked_batch`, before it
is pinned). On the CPU (`device` "cpu") the thread passes the batches
through.
"""

import queue
import threading
from typing import Optional

import torch

from ..training.prepare import RawBatch
from .mesh import shard_batch


def to_device(batch: RawBatch, device, non_blocking: bool = False) -> RawBatch:
    return RawBatch(**{n: None if getattr(batch, n) is None else
                       getattr(batch, n).to(device, non_blocking=non_blocking)
                       for n in RawBatch.__dataclass_fields__})


class DevicePrefetcher:
    def __init__(self, host_iter, device, depth: int = 2, mesh=None):
        self.device = torch.device(device)
        if mesh is not None:
            host_iter = (shard_batch(batch, mesh) for batch in host_iter)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        cuda = self.device.type == "cuda"
        self._stream: Optional[torch.cuda.Stream] = (torch.cuda.Stream(self.device)
                                                     if cuda else None)

        def worker():
            try:
                if cuda:
                    torch.cuda.set_device(self.device)
                for batch in host_iter:
                    if cuda:
                        with torch.cuda.stream(self._stream):
                            staged = to_device(batch, self.device, non_blocking=True)
                            event = torch.cuda.Event()
                            event.record(self._stream)
                    else:
                        staged, event = batch, None
                    while not self._stop.is_set():
                        try:
                            self._q.put((staged, event), timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
            except Exception as e:  # raised by next()
                self._q.put((e, None))

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def close(self):
        """Stop the staging thread (when training ends)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __iter__(self):
        return self

    def __next__(self) -> RawBatch:
        staged, event = self._q.get()
        if isinstance(staged, Exception):
            raise staged
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for n in RawBatch.__dataclass_fields__:
                t = getattr(staged, n)
                if t is not None:
                    t.record_stream(consumer)
        return staged
