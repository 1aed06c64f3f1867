"""K1-bwd-upsample: the backward of the encoder's bilinear upsampling
(half-pixel centres) as a fixed-order gather — the CUDA kernel and its plain
version.

No Pallas site: JAX upsamples with jax.image.resize "linear"
(neural_jacobian_field_tpu/models/encoder_resnet.py:289) and XLA's autodiff
sums its backward in a fixed order. PyTorch's CUDA backward
(upsample_bilinear2d_backward) adds with atomics, so the port takes this one
(`ops/deterministic.upsample_bilinear`). The plain version is the corner
table of every output pixel (`_upsample_corners`) scattered by
`row_scatter_plain`: each input texel's terms summed in output-pixel order,
then corner order (y0x0, y0x1, y1x0, y1x1), the weights rounded to g's
dtype, in float32 from 0, rounded once. The kernel
(csrc/upsample_bwd.cu) reads no table and sorts nothing: each thread walks
the output rows and columns whose corners land on its texel, from the
source-coordinate formula, in that order, and equals the plain version bit
for bit.

Dispatch is by device: a CUDA tensor launches the kernel (or raises), a CPU
tensor takes the plain version.
"""

from typing import Tuple

import torch

from .build import check_cuda_tensor, dispatch, load_kernels, stream_of
from .conv_suite import _on_device
from .onehot_gather import _dtype_flag, row_scatter_plain


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


def upsample_bilinear_bwd_plain(g: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """g [B, Ho, Wo, C] (NHWC), the gradient of a bilinear resize from
    size = (Hi, Wi) -> [B, Hi, Wi, C] in g's dtype: the corner table scattered
    in entry order, one table for every image."""
    b, ho, wo, c = g.shape
    hi, wi = size
    ids, w = _upsample_corners(hi, wi, ho, wo, g.dtype, g.device)
    gx = row_scatter_plain(g.reshape(b, ho * wo, c), ids[None], w[None], hi * wi)
    return gx.reshape(b, hi, wi, c)


def _upsample_bilinear_bwd_cuda(g, size):
    if g.dim() != 4 or len(size) != 2 or min(size) <= 0:
        raise ValueError(f"upsample_bilinear_bwd: expected g [B, Ho, Wo, C] and (Hi, Wi), got "
                         f"{tuple(g.shape)}, {tuple(size)}")
    g = g.contiguous()
    b, ho, wo, c = g.shape
    hi, wi = (int(s) for s in size)
    is_f32 = _dtype_flag("upsample_bilinear_bwd g", g)
    check_cuda_tensor(g, "upsample_bilinear_bwd g", g.dtype, 4)
    out = torch.empty((b, hi, wi, c), dtype=g.dtype, device=g.device)
    if out.numel() == 0:
        return out
    if ho * wo == 0:
        return out.zero_()
    lib = load_kernels()
    with _on_device(g):
        upsample_bilinear_bwd.launches += 1
        lib.call("njf_upsample_bwd", g.data_ptr(), out.data_ptr(), b, hi, wi, ho, wo, c, is_f32,
                 stream_of(g))
    return out


def upsample_bilinear_bwd(g: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """K1-bwd-upsample's wrapper (same signature as the plain version; bf16
    or float32 g on the card, the output in g's dtype)."""
    return dispatch("upsample_bilinear_bwd", g, lambda: _upsample_bilinear_bwd_cuda(g, size),
                    lambda: upsample_bilinear_bwd_plain(g, size))


upsample_bilinear_bwd.launches = 0
