"""Data parallelism across cards (PyTorch counterpart of parallel/mesh.py,
the replacement there for PyTorch-Lightning's DDP).

The JAX package lays a 1-D mesh over the devices: the batch axis is sharded,
parameters and optimizer state are replicated, and `jax.jit` of the train
step inserts the all-reduces. Here each rank is a process with one card (or,
for tests and a one-card machine, a share of one card or of the CPU) in a
`torch.distributed` process group, `Mesh`. A step on the rank's rows of a
global batch of B computes what the one-process step computes on the whole
batch, the order of the all-reduce's sums aside:

- the BatchNorm statistics of training mode are the global batch's
  (`models/encoder_resnet.BatchNorm`: the per-channel sums, or means, summed
  over the ranks by `all_reduce_sum`, which differentiates as JAX's psum);
- the masked mean of the tracks loss divides the global sum by the global
  count (`training/losses.action_loss`); a plain mean's global value is the
  mean of the ranks' means, as the shards are equal;
- the gradients are averaged over the ranks before clipping and Adam
  (`all_reduce_mean_`, one flat buffer per dtype in the optimizer's
  parameter order), so parameters stay bit for bit equal on every rank;
- the logged metrics are the global batch's.

The step's collectives read the mesh that `data_parallel(mesh)` makes
active around it; with no mesh active nothing here runs and one process
computes what it always did. With NCCL the whole step, collectives
included, is captured as a CUDA graph (training/train.py); a gloo group
cannot be captured, so its steps run eagerly.
"""

import contextlib
import dataclasses
import datetime
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

_ACTIVE: List["Mesh"] = []


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D data-parallel mesh: this process's rank in `group`, the number
    of ranks, and the rank's device."""

    group: object  # the torch.distributed process group
    rank: int
    size: int
    device: torch.device
    backend: str  # "nccl" or "gloo"

    @property
    def captures(self) -> bool:
        """Whether a step's collectives can run inside a CUDA graph (NCCL's
        can; gloo's copy through the host and cannot)."""
        return self.backend == "nccl"

    def rows(self, b: int, what: str = "batch") -> slice:
        """This rank's rows of a dimension of b: the rank-th of size equal
        parts. Raises where b does not divide by the size (as JAX's
        device_put of a sharded array does)."""
        if b % self.size:
            raise ValueError(f"{what} of {b} does not divide over {self.size} ranks")
        n = b // self.size
        return slice(self.rank * n, (self.rank + 1) * n)


def make_mesh(device=None, init_method: Optional[str] = None, rank: Optional[int] = None,
              world_size: Optional[int] = None, backend: Optional[str] = None,
              timeout_s: float = 600.0) -> Mesh:
    """The process group of this rank, set up once per process (the default
    group; a later call reuses it), and the rank's device.

    Without `init_method` the group comes from torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); it raises where the
    environment names none. `device`: None is the card cuda:LOCAL_RANK
    (raises without a card), "cpu" the CPU; `backend`: None is NCCL on the
    card and gloo on the CPU. "gloo" on the card runs several ranks on one
    card (NCCL refuses two ranks on one GPU); "nccl" without a card raises."""
    if init_method is None:
        missing = [k for k in ("RANK", "WORLD_SIZE") if k not in os.environ]
        if missing and not dist.is_initialized():
            raise RuntimeError(f"make_mesh: no process group: the environment lacks {missing} "
                               "(run under torchrun, or pass init_method, rank and world_size)")
    local = int(os.environ.get("LOCAL_RANK", rank if rank is not None else 0))
    device = torch.device("cuda" if device is None else device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"make_mesh: unknown backend {backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise RuntimeError(f"make_mesh: NCCL needs a CUDA device, got {device}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' for gloo ranks "
                               "on the CPU")
        if device.index is None:
            device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        kw = dict(backend=backend, timeout=datetime.timedelta(seconds=timeout_s))
        if init_method is not None:
            kw.update(init_method=init_method, rank=rank, world_size=world_size)
        dist.init_process_group(**kw)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"make_mesh: the process group is {dist.get_backend()}, "
                           f"not {backend}")
    mesh = Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(), device, backend)
    # the communicator exists before any step is captured (NCCL makes it at
    # the first collective, which a capture may not hold)
    dist.all_reduce(torch.zeros(1, device=device), group=mesh.group)
    return mesh


def close_mesh() -> None:
    """Destroy the default process group, where there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


# ------------------------------------------------------------ the active mesh

@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh]):
    """Make `mesh` the one the step's BatchNorm, losses and metrics reduce
    over inside the block (None: no mesh, one process's step)."""
    if mesh is None:
        yield
        return
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def active_mesh() -> Optional[Mesh]:
    """The mesh of the step running, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


# ---------------------------------------------------------------- collectives

class _AllReduceSum(torch.autograd.Function):
    """y = the sum over ranks of x, on every rank; its backward sums the
    cotangents over the ranks (JAX's psum transposes to a psum), so that,
    after the gradients' mean over the ranks, each parameter's gradient is
    the one-process gradient of the global loss."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.mesh.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of x over the ranks, differentiable (a new tensor)."""
    return _AllReduceSum.apply(x, mesh)


def all_reduce(x: torch.Tensor, mesh: Mesh, op: str = "sum") -> torch.Tensor:
    """x reduced over the ranks by "sum", "min" or "max", outside autograd
    (a new tensor)."""
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op={"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
                           "max": dist.ReduceOp.MAX}[op], group=mesh.group)
    return y


def all_gather(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's x (each shaped alike) concatenated along `dim` in rank
    order, on every rank, outside autograd."""
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts, dim=dim)


def all_reduce_mean_(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Each tensor replaced in place by its mean over the ranks, through one
    flat buffer per dtype in the given order (the gradients, in the
    optimizer's parameter order). NCCL averages in the collective (a kernel
    even on one rank, where an in-place sum launches none): it premultiplies
    by 1 / size, which is exact for a power-of-two size, so on such a count
    of cards it differs from gloo's sum-then-divide only in the order of
    the sum. gloo sums and divides."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        if mesh.backend == "nccl":
            dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=mesh.group)
        else:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
            flat.div_(mesh.size)
        for t, v in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(v.view_as(t))


@torch.no_grad()
def replicate(state, mesh: Mesh):
    """Broadcast a train state's parameters, buffers and optimizer state
    from rank 0 to every rank, in place (the JAX `replicate`); returns it."""
    for t in [*state.model.parameters(), *state.model.buffers(),
              *state.optimizer.state_tensors()]:
        dist.broadcast(t.data, src=0, group=mesh.group)
    return state


# -------------------------------------------------------------------- batches

def _map_leaves(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: _map_leaves(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return tree


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of dim 0 of every tensor of `batch` (a RawBatch, or
    dataclasses, dicts, tuples of tensors). Raises where a leading dim does
    not divide by the number of ranks."""
    return _map_leaves(lambda t: t[mesh.rows(t.shape[0], "a batch dimension")], batch)


def shard_stacked_batch(stacked, mesh: Mesh):
    """`shard_batch` on dim 1 of a `stack_batches` result (dim 0 is the [K]
    steps axis, kept whole on every rank)."""
    return _map_leaves(lambda t: t[:, mesh.rows(t.shape[1], "a batch dimension")], stacked)


def shard_rows(x: torch.Tensor, mesh: Optional[Mesh], dim: int = 0) -> torch.Tensor:
    """x's rows of this rank along `dim` (x as it is without a mesh)."""
    if mesh is None:
        return x
    return x.narrow(dim, mesh.rows(x.shape[dim]).start, x.shape[dim] // mesh.size)

