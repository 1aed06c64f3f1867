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
"""

import collections
import queue
import random
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from ..training.prepare import RawBatch
from .dataset import DatasetCommon


def _pad_tracks(item: dict, num_tracks: int) -> dict:
    sel = item["pixel_selector"]
    n = len(sel)
    if n >= num_tracks:
        keep = np.random.permutation(n)[:num_tracks]
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
    """Random-sampling loader with background threads (`num_workers` of them;
    0 makes each batch in the consumer's thread)."""

    def __init__(self, dataset: DatasetCommon, batch_size: int,
                 num_tracks: Optional[int] = None, num_workers: int = 2,
                 prefetch: int = 4, seed: int = 0, decode_threads: int = 8,
                 pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
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

    def _make_batch(self) -> RawBatch:
        batch = self._collate_batch()
        return pin(batch) if self.pin_memory else batch

    def _collate_batch(self) -> RawBatch:
        idxs = [self._rng.randrange(len(self.dataset)) for _ in range(self.batch_size)]
        if self._native:
            try:
                batch = self._make_batch_native(idxs)
                if batch is not None:
                    self.paths["native"] += 1
                    return batch
            except (IOError, OSError):
                pass  # a corrupt file: the per-item path has the retry semantics
        self.paths["per-item"] += 1
        return collate([self.dataset[i] for i in idxs], self.num_tracks)

    def _make_batch_native(self, idxs) -> Optional[RawBatch]:
        """The batch through the native decoder, or None where it cannot make
        it (mixed resolutions, tracks supervision)."""
        from .native import decode_depth_batch, decode_rgb_batch_u8, load_flow_npz_batch

        plans = [self.dataset.plan_item(i) for i in idxs]
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
        if self.num_workers == 0:
            while True:
                yield self._make_batch()

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        self._stops.append(stop)

        def worker():
            while not stop.is_set():
                try:
                    batch = self._make_batch()
                except Exception as e:  # raised in the consumer's thread
                    batch = e
                while not stop.is_set():
                    try:
                        q.put(batch, timeout=0.5)
                        break
                    except queue.Full:
                        continue

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            while True:
                batch = q.get()
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
