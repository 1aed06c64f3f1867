"""Data parallelism across cards and host-to-device staging (PyTorch
counterpart of the JAX package's parallel/): the torch.distributed mesh and
its collectives (mesh.py), the prefetcher that shards each batch before it
copies it (prefetch.py), spawned ranks (launch.py) and the multi-rank dry
run (dryrun.py)."""

from .mesh import (
    Mesh,
    active_mesh,
    all_gather,
    all_reduce,
    all_reduce_mean_,
    all_reduce_sum,
    close_mesh,
    data_parallel,
    make_mesh,
    replicate,
    shard_batch,
    shard_stacked_batch,
)
from .prefetch import DevicePrefetcher, to_device
