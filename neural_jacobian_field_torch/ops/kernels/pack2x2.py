"""K6: 2x2 patch packing for the pixel-gather layout — CUDA kernels for the
packing and its gradient, their plain versions, and the differentiable
`pack_2x2_flat_train` (an autograd.Function over the two).

Replaces neural_jacobian_field_tpu/ops/pallas/pack2x2.py: `pack_2x2_flat`
there is a custom_vjp whose forward is `_pack_fwd_pallas` (K6-fwd) and whose
backward is `_pack_bwd_pallas` (K6-bwd).
[B, H, W, C] -> [B, H*W, 4C]: packed row (y, x) holds
[F(y, x), F(y, x+1), F(y+1, x), F(y+1, x+1)] with the last row and column
replicated; the backward folds each slot's gradient back onto its texel,
border duplicates included. Both kernels live in csrc/pack2x2.cu (its header
says what bounds them). The forward is a vectorised grid-stride copy that
takes any dtype (it moves bytes); the backward adds, in float32 or bf16, in
the TPU kernel's order. Both take any W and C (the TPU shape gate,
pack2x2.py:112-117, is gone).

Dispatch is by device: a CUDA tensor launches the kernel (or raises), a CPU
tensor takes the plain version. The Function looks its wrappers up in this
module at call time, so swapping a wrapper for its plain version here swaps
it for the forward and the backward alike.
"""

import torch

from .build import check_cuda_tensor, dispatch, load_kernels, stream_of


def pack_2x2_flat_plain(level: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: pack_2x2 + flatten."""
    from ..pixel_gather import pack_2x2

    b, h, w, c = level.shape
    return pack_2x2(level).reshape(b, h * w, 4 * c)


def _unshift_x(v: torch.Tensor) -> torch.Tensor:
    """Transpose of the right shift along W (dim 2) that replicates the last
    column: d[x] = v[x-1] (nothing at x = 0), and the last column also keeps
    its own v (the border duplicate)."""
    d = torch.cat([torch.zeros_like(v[:, :, :1]), v[:, :, :-1]], dim=2)
    return torch.cat([d[:, :, :-1], d[:, :, -1:] + v[:, :, -1:]], dim=2)


def pack_2x2_flat_bwd_plain(g: torch.Tensor, h: int) -> torch.Tensor:
    """Plain version of the fold: g [B, H*W, 4C] -> d [B, H, W, C], summed in
    the TPU kernel's order (`_bwd_kernel`), one rounding per addition in g's
    dtype."""
    b, hw, c4 = g.shape
    w, c = hw // h, c4 // 4
    gi = g.reshape(b, h, w, c4)

    def fold(y0, y1, q):  # slot q (+ the unshifted slot q+1) of rows y0:y1
        return gi[:, y0:y1, :, q * c:(q + 1) * c] + _unshift_x(gi[:, y0:y1, :, (q + 1) * c:(q + 2) * c])

    d = fold(0, h, 0)
    if h > 1:
        d = torch.cat([d[:, :1], d[:, 1:] + fold(0, h - 1, 2)], dim=1)
    return torch.cat([d[:, :-1], d[:, -1:] + fold(h - 1, h, 2)], dim=1)


def _pack_2x2_flat_cuda(level: torch.Tensor) -> torch.Tensor:
    if level.dim() != 4:
        raise ValueError(f"pack_2x2_flat: expected [B, H, W, C], got {tuple(level.shape)}")
    level = level.contiguous()
    b, h, w, c = level.shape
    out = torch.empty((b, h * w, 4 * c), dtype=level.dtype, device=level.device)
    if out.numel() == 0:
        return out
    lib = load_kernels()
    with torch.cuda.device(level.device):
        pack_2x2_flat.launches += 1
        lib.call("njf_pack2x2_fwd", level.data_ptr(), out.data_ptr(), b, h, w,
                 c * level.element_size(), stream_of(level))
    return out


def pack_2x2_flat(level: torch.Tensor) -> torch.Tensor:
    """K6-fwd wrapper: [B, H, W, C] -> [B, H*W, 4C] packed rows."""
    return dispatch("pack_2x2_flat", level, lambda: _pack_2x2_flat_cuda(level),
                    lambda: pack_2x2_flat_plain(level))


_BWD_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _pack_2x2_flat_bwd_cuda(g: torch.Tensor, h: int) -> torch.Tensor:
    if g.dim() != 3 or g.shape[1] % h or g.shape[2] % 4:
        raise ValueError(f"pack_2x2_flat_bwd: g {tuple(g.shape)} with H {h}")
    if g.dtype not in _BWD_DTYPES:
        raise TypeError(f"pack_2x2_flat_bwd: takes float32 or bf16, got {g.dtype}")
    g = g.contiguous()
    check_cuda_tensor(g, "pack_2x2_flat_bwd g", g.dtype, 3)
    b, hw, c4 = g.shape
    w, c = hw // h, c4 // 4
    d = torch.empty((b, h, w, c), dtype=g.dtype, device=g.device)
    if d.numel() == 0:
        return d
    lib = load_kernels()
    with torch.cuda.device(g.device):
        pack_2x2_flat_bwd.launches += 1
        lib.call("njf_pack2x2_bwd", g.data_ptr(), d.data_ptr(), b, h, w, c,
                 _BWD_DTYPES[g.dtype], stream_of(g))
    return d


def pack_2x2_flat_bwd(g: torch.Tensor, h: int) -> torch.Tensor:
    """K6-bwd wrapper: the gradient of the packing, [B, H*W, 4C] -> [B, H, W, C]."""
    return dispatch("pack_2x2_flat_bwd", g, lambda: _pack_2x2_flat_bwd_cuda(g, h),
                    lambda: pack_2x2_flat_bwd_plain(g, h))


pack_2x2_flat.launches = 0
pack_2x2_flat_bwd.launches = 0


class Pack2x2Flat(torch.autograd.Function):
    """The differentiable packing (the JAX `pack_2x2_flat` custom_vjp)."""

    @staticmethod
    def forward(ctx, level):
        ctx.h = level.shape[1]
        return pack_2x2_flat(level)

    @staticmethod
    def backward(ctx, g):
        return pack_2x2_flat_bwd(g.contiguous(), ctx.h)


def pack_2x2_flat_train(level: torch.Tensor) -> torch.Tensor:
    """Differentiable [B, H, W, C] -> [B, H*W, 4C]: K6-fwd forward, K6-bwd
    backward."""
    return Pack2x2Flat.apply(level)
