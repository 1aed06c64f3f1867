"""The random streams the data pipeline draws from.

The dataset, its augmentations and the loader's track padding draw through
`pyrandom()` and `nprandom()`: by default the global `random` module and
`np.random`, which makes the JAX package's draws in its order (the same
seeds give the same items). Inside `item_streams(*key)` the calling thread
draws instead from a `random.Random` and an `np.random.RandomState` seeded
by the key alone, so that an item is a function of its key, whichever
thread makes it and whatever else draws meanwhile: the items of the
data-parallel loader (data/loader.py, `shard`)."""

import contextlib
import random
import threading

import numpy as np

_local = threading.local()


def pyrandom():
    """The calling thread's stream of the `random` module's functions."""
    return getattr(_local, "py", random)


def nprandom():
    """The calling thread's stream of `np.random`'s functions."""
    return getattr(_local, "np", np.random)


@contextlib.contextmanager
def item_streams(*key: int):
    """Draw from streams seeded by `key` (non-negative ints) on this thread
    inside the block."""
    words = np.random.SeedSequence(list(key)).generate_state(4)
    saved = _local.__dict__.copy()
    _local.py = random.Random(int.from_bytes(words.tobytes(), "little"))
    _local.np = np.random.RandomState(words)
    try:
        yield
    finally:
        _local.__dict__.clear()
        _local.__dict__.update(saved)
