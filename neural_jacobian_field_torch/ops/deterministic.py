"""Fixed-order backwards: what makes a train step repeat bit for bit on the
card, as the JAX step repeats on the CPU or the TPU.

PyTorch's CUDA backward of a gather (scatter_add_) and of a bilinear
upsampling add their terms with atomics, and cuDNN may pick a convolution
backward that does too: the sums come in another order from run to run,
and a step's gradients differ in their last bits. Here:
  - `gather_rows`: torch.gather of whole rows, its backward the generalised
    K1-bwd scatter (`kernels.onehot_gather.row_scatter`, Q = 1, unit
    weights; looked up there at each call, as chip_smoke's plain_kernels
    swaps it), which sorts the entries by row and sums them in order;
  - `upsample_bilinear`: F.interpolate's bilinear (half-pixel centres), its
    backward the same scatter with the four corners of each output pixel
    and their weights (Q = 4), one table for every image;
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
        return k1.row_scatter(g.to(ctx.dtype), idx[..., None], None, ctx.k), None


def gather_rows(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat [B, K, C], idx [B, M] row ids in [0, K) -> [B, M, C], rows of
    flat; flat's gradient summed per row in a fixed order (in float32, or
    float64 for float64, then rounded to flat's dtype)."""
    return _GatherRows.apply(flat, idx)


def _upsample_corners(hi: int, wi: int, ho: int, wo: int, dtype, device):
    """Corner ids [Ho * Wo, 4] and weights [Ho * Wo, 4] of PyTorch's bilinear
    upsampling with half-pixel centres (align_corners=False): source
    coordinate max(scale (dst + 0.5) - 0.5, 0) with scale = in / out, the
    next row or column clamped to the last, corners (y0x0, y0x1, y1x0,
    y1x1), in `dtype` (float32, or float64 for float64, as PyTorch computes
    them)."""
    acc = torch.float64 if dtype == torch.float64 else torch.float32

    def axis(n_in, n_out):
        src = (torch.arange(n_out, device=device, dtype=acc) + 0.5) * (n_in / n_out) - 0.5
        src = torch.clamp(src, min=0.0)
        i0 = src.long()
        i1 = torch.clamp(i0 + 1, max=n_in - 1)
        hi_w = src - i0.to(acc)
        return i0, i1, 1.0 - hi_w, hi_w

    y0, y1, hy, ly = axis(hi, ho)
    x0, x1, hx, lx = axis(wi, wo)
    ids = torch.stack([(y0 * wi)[:, None] + x0[None, :], (y0 * wi)[:, None] + x1[None, :],
                       (y1 * wi)[:, None] + x0[None, :], (y1 * wi)[:, None] + x1[None, :]],
                      dim=-1).reshape(ho * wo, 4)
    w = torch.stack([hy[:, None] * hx[None, :], hy[:, None] * lx[None, :],
                     ly[:, None] * hx[None, :], ly[:, None] * lx[None, :]],
                    dim=-1).reshape(ho * wo, 4)
    return ids, w


_CORNERS = {}


def _corners(hi: int, wi: int, ho: int, wo: int, dtype, device):
    """_upsample_corners as one table for every image, [1, Ho * Wo, 4] ids
    and weights, kept per shape; not kept when made while a CUDA graph is
    captured (its values would be written only when the graph replays)."""
    key = (hi, wi, ho, wo, dtype, device)
    table = _CORNERS.get(key)
    if table is None:
        table = tuple(t[None] for t in _upsample_corners(hi, wi, ho, wo, dtype, device))
        if not (device.type == "cuda" and torch.cuda.is_current_stream_capturing()):
            _CORNERS[key] = table
    return table


class _UpsampleBilinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, size):
        ctx.shape, ctx.dtype = x.shape, x.dtype
        y = F.interpolate(x.permute(0, 3, 1, 2), size=size, mode="bilinear",
                          align_corners=False)
        return y.permute(0, 2, 3, 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        b, hi, wi, c = ctx.shape
        _, ho, wo, _ = g.shape
        ids, w = _corners(hi, wi, ho, wo, ctx.dtype, g.device)
        gx = k1.row_scatter(g.to(ctx.dtype).reshape(b, ho * wo, c), ids, w, hi * wi)
        return gx.reshape(b, hi, wi, c), None


def upsample_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """x [B, H, W, C] (NHWC) -> [B, *size, C], bilinear with half-pixel
    centres (F.interpolate's align_corners=False; for upsampling, JAX's
    jax.image.resize "linear"); x's gradient summed per texel in a fixed
    order."""
    return _UpsampleBilinear.apply(x, tuple(size))
