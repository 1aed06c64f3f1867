"""Host data loader: sample, collate, prefetch (PyTorch counterpart of
data/loader.py). Emits the port's `RawBatch` of CPU tensors with static
shapes: tracks are padded or truncated to a fixed count, the visibility
mask zeroed on the padding.

Two ways to make a batch, as in the JAX package: the per-item path (each
item decoded by the dataset, data/image_io.py; float32 RGB), and, where
the native decoder builds (data/native.py) and the dataset needs no
per-item Python work, one threaded C++ call per modality over the whole
batch (uint8 RGB; training/prepare.py normalises it on the device).
`DataLoader.paths` counts the batches each path made. With `pin_memory`
the tensors are put in page-locked memory, so that the copy to a card can
run asynchronously (parallel/prefetch.py).

With `shard=(rank, size)` the loader makes this rank's rows of each global
batch of a data-parallel run, as a distributed sampler does: item j of
global batch t draws its index and all its choices from streams seeded by
(seed, t, j) alone (data/streams.py), so each rank decodes only its own
rows, with its own workers, and the ranks' rows together are the global
batch that any rank count (one included) makes from that seed.
"""

import collections
import itertools
import queue
import random
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..training.prepare import RawBatch
from .dataset import DatasetCommon
from .streams import item_streams, nprandom, pyrandom


def _pad_tracks(item: dict, num_tracks: int) -> dict:
    sel = item["pixel_selector"]
    n = len(sel)
    if n >= num_tracks:
        keep = nprandom().permutation(n)[:num_tracks]
        return {
            "pixel_selector": sel[keep],
            "pixel_motion": item["pixel_motion"][keep],
            "pixel_visible_mask": item["pixel_visible_mask"][keep],
        }
    pad = num_tracks - n
    return {
        "pixel_selector": np.concatenate([sel, np.zeros(pad, sel.dtype)]),
        "pixel_motion": np.concatenate([item["pixel_motion"], np.zeros((pad, 2), np.float32)]),
        # padding is masked OUT (visible=0), unlike real negatives (visible=1)
        "pixel_visible_mask": np.concatenate(
            [item["pixel_visible_mask"], np.zeros(pad, np.float32)]),
    }


def _batch(arrays: dict) -> RawBatch:
    """A RawBatch of CPU tensors from name -> stacked array (absent: None)."""
    return RawBatch(**{name: None if arrays.get(name) is None else torch.from_numpy(
        np.ascontiguousarray(arrays[name])) for name in RawBatch.__dataclass_fields__})


def collate(items, num_tracks: Optional[int] = None) -> RawBatch:
    """Stack item dicts into a RawBatch of CPU tensors."""
    if "pixel_selector" in items[0] and num_tracks is not None:
        items = [{**it, **_pad_tracks(it, num_tracks)} for it in items]
    return _batch({key: np.stack([np.asarray(it[key]) for it in items], axis=0)
                   for key in items[0]})


def pin(batch: RawBatch) -> RawBatch:
    """The batch in page-locked host memory."""
    return RawBatch(**{n: None if getattr(batch, n) is None else getattr(batch, n).pin_memory()
                       for n in RawBatch.__dataclass_fields__})


class DataLoader:
    """Random-sampling loader with background threads (`num_workers` of them,
    worker w making batches w, w + workers, ..., handed out in order; 0
    makes each batch in the consumer's thread). `shard=(rank, size)`: this
    rank's batch_size / size rows of each global batch of batch_size, each
    item a function of (seed, batch, row) (see the module docstring)."""

    def __init__(self, dataset: DatasetCommon, batch_size: int,
                 num_tracks: Optional[int] = None, num_workers: int = 2,
                 prefetch: int = 4, seed: int = 0, decode_threads: int = 8,
                 pin_memory: bool = False, shard: Optional[Tuple[int, int]] = None):
        if shard is not None and batch_size % shard[1]:
            raise ValueError(f"a batch of {batch_size} does not divide over {shard[1]} ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shard = shard
        self.seed = seed
        self.num_tracks = num_tracks
        self.num_workers = max(0, num_workers)
        self.prefetch = prefetch
        self.decode_threads = decode_threads
        self.pin_memory = pin_memory
        self._rng = random.Random(seed)
        self.paths = collections.Counter()  # "native" / "per-item" -> batches made
        self._stops = []
        from .native import get_lib

        self._native = get_lib() is not None and not getattr(
            dataset, "needs_python_items", True)

    def _make_batch(self, t: int) -> RawBatch:
        batch = self._collate_batch(t)
        return pin(batch) if self.pin_memory else batch

    def _keyed(self, fn, t: int) -> list:
        """fn(index) for each of this rank's rows j of global batch t, under
        the streams of (seed, t, j), which also draw the index."""
        rank, size = self.shard
        n = self.batch_size // size
        out = []
        for j in range(rank * n, (rank + 1) * n):
            with item_streams(self.seed, t, j):
                out.append(fn(pyrandom().randrange(len(self.dataset))))
        return out

    def _item(self, i: int) -> dict:
        item = self.dataset[i]
        if self.num_tracks is not None and "pixel_selector" in item:
            item = {**item, **_pad_tracks(item, self.num_tracks)}
        return item

    def _collate_batch(self, t: int) -> RawBatch:
        if self.shard is None:
            idxs = [self._rng.randrange(len(self.dataset)) for _ in range(self.batch_size)]
        if self._native:
            try:
                plans = ([self.dataset.plan_item(i) for i in idxs] if self.shard is None
                         else self._keyed(self.dataset.plan_item, t))
                batch = self._make_batch_native(plans)
                if batch is not None:
                    self.paths["native"] += 1
                    return batch
            except (IOError, OSError):
                pass  # a corrupt file: the per-item path has the retry semantics
        self.paths["per-item"] += 1
        if self.shard is None:
            return collate([self.dataset[i] for i in idxs], self.num_tracks)
        return collate(self._keyed(self._item, t))

    def _make_batch_native(self, plans) -> Optional[RawBatch]:
        """The batch of these items' plans through the native decoder, or
        None where it cannot make it (mixed resolutions, tracks supervision)."""
        from .native import decode_depth_batch, decode_rgb_batch_u8, load_flow_npz_batch

        b = len(plans)
        hw = plans[0]["hw_ctxt"]
        if any(p["hw_ctxt"] != hw or p["hw_trgt"] != hw for p in plans) or \
           any(p["tracks_args"] is not None for p in plans):
            # the plans drew from the global streams: the per-item path that
            # follows draws again, as the JAX loader's does
            return None
        h, w = hw
        t = self.decode_threads
        rgb = decode_rgb_batch_u8([p["ctxt_path"] for p in plans]
                                  + [p["trgt_path"] for p in plans], h, w, threads=t)
        depth = decode_depth_batch([p["depth_path"] for p in plans], h, w,
                                   scale=plans[0]["depth_scale"], threads=t)
        flow = None
        if plans[0]["flow_path"] is not None:
            flow = load_flow_npz_batch([p["flow_path"] for p in plans], h, w, threads=t)
        arrays = {key: np.stack([p[key] for p in plans], axis=0) for key in (
            "ctxt_extrinsics", "ctxt_intrinsics", "robot_action", "trgt_extrinsics",
            "trgt_intrinsics", "near", "far")}
        return _batch({**arrays, "ctxt_rgb": rgb[:b], "trgt_rgb": rgb[b:],
                       "trgt_depth": depth, "flow": flow})

    def __iter__(self) -> Iterator[RawBatch]:
        """Batches 0, 1, 2, ... in order (a new iterator starts again at 0)."""
        if self.num_workers == 0:
            for t in itertools.count():
                yield self._make_batch(t)

        workers = self.num_workers
        qs = [queue.Queue(maxsize=max(1, -(-self.prefetch // workers))) for _ in range(workers)]
        stop = threading.Event()
        self._stops.append(stop)

        def worker(w):
            for t in itertools.count(w, workers):
                if stop.is_set():
                    return
                try:
                    batch = self._make_batch(t)
                except Exception as e:  # raised in the consumer's thread
                    batch = e
                while not stop.is_set():
                    try:
                        qs[w].put(batch, timeout=0.5)
                        break
                    except queue.Full:
                        continue

        for w in range(workers):
            threading.Thread(target=worker, args=(w,), daemon=True).start()
        try:
            for t in itertools.count():
                batch = qs[t % workers].get()
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()


    def close(self) -> None:
        """Stop the worker threads of every iterator (each ends after the
        batch it is making)."""
        for stop in self._stops:
            stop.set()


class ValidationWrapper:
    """Length-1 dataset serving one random underlying item per epoch:
    validation renders are expensive, so each pass samples one scene."""

    def __init__(self, dataset, seed: int = 0):
        self.dataset = dataset
        self._rng = random.Random(seed)

    def __len__(self) -> int:
        return 1

    def __getitem__(self, idx: int):
        return self.dataset[self._rng.randrange(len(self.dataset))]
