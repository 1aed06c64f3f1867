"""Fixed-order backwards: what makes a train step repeat bit for bit on the
card, as the JAX step repeats on the CPU or the TPU.

PyTorch's CUDA backward of a gather (scatter_add_) and of a bilinear
upsampling add their terms with atomics, and cuDNN may pick a convolution
backward that does too: the sums come in another order from run to run,
and a step's gradients differ in their last bits. Here:
  - `gather_rows`: torch.gather of whole rows, its backward a scatter that
    sums each row's entries in entry order: K1-bwd-small
    (`kernels.onehot_gather.small_scatter`: one block per image, sorted in
    shared memory; the interlevel loss's per-ray rows) where
    `small_plan` admits the shape, else K1-bwd-rows (`row_scatter`, Q = 1,
    unit weights, for the pyramid's packed rows, the knots and the lookups:
    a sort of the entries by block of rows, then by row within each block,
    and a thread block per (block of rows, image, 256 channels), or two in a
    dense call on few blocks, that writes every row of its block once; a
    row of more than 128 entries is summed in pieces added in order); both
    looked up in their module at each
    call, as chip_smoke's plain_kernels swaps them;
  - `upsample_bilinear`: F.interpolate's bilinear (half-pixel centres), its
    backward K1-bwd-upsample (`kernels.upsample_bwd.upsample_bilinear_bwd`),
    a gather over each input texel's output stencil in the order of the
    corner table's scatter, from the source-coordinate formula;
  - `deterministic_cudnn`: cuDNN limited to deterministic algorithms for the
    span of a train step, the caller's other cuDNN settings kept.
The forwards are PyTorch's own ops, bit for bit as before. The max-pools
need nothing: PyTorch's CUDA max_pool2d backward already gathers, for each
input pixel, from the windows that chose it, in a fixed order (chip_smoke
holds two calls at the stem's shape, ties included, bit-identical).
"""

import contextlib
from typing import Tuple

import torch
import torch.nn.functional as F

from .kernels import onehot_gather as k1
from .kernels import upsample_bwd as kup


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms only, inside the block (forward and
    backward of a step, and its capture: a graph replays the algorithms
    chosen while it was captured). Not a process-wide flag: the setting it
    found is restored on exit."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    cudnn.deterministic = True
    try:
        yield
    finally:
        cudnn.deterministic = saved


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flat, idx):
        ctx.save_for_backward(idx)
        ctx.k, ctx.dtype = flat.shape[1], flat.dtype
        return torch.gather(flat, 1, idx[..., None].expand(-1, -1, flat.shape[-1]))

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        g = g.to(ctx.dtype)
        if k1.small_plan(g.shape[1], ctx.k, g.shape[2]) is not None:
            return k1.small_scatter(g, idx, ctx.k), None
        return k1.row_scatter(g, idx[..., None], None, ctx.k), None


def gather_rows(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat [B, K, C], idx [B, M] row ids in [0, K) -> [B, M, C], rows of
    flat; flat's gradient summed per row in a fixed order (in float32, or
    float64 for float64, then rounded to flat's dtype)."""
    return _GatherRows.apply(flat, idx)


class _UpsampleBilinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, size):
        ctx.shape, ctx.dtype = x.shape, x.dtype
        y = F.interpolate(x.permute(0, 3, 1, 2), size=size, mode="bilinear",
                          align_corners=False)
        return y.permute(0, 2, 3, 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        return kup.upsample_bilinear_bwd(g.to(ctx.dtype), ctx.shape[1:3]), None


def upsample_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """x [B, H, W, C] (NHWC) -> [B, *size, C], bilinear with half-pixel
    centres (F.interpolate's align_corners=False; for upsampling, JAX's
    jax.image.resize "linear"); x's gradient summed per texel in a fixed
    order."""
    return _UpsampleBilinear.apply(x, tuple(size))
