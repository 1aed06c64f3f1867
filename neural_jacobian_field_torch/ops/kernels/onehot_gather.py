"""K1 (coarse level): bilinear gather of a small feature map and the scatter
of its gradient — CUDA kernels and their plain versions.

Replaces neural_jacobian_field_tpu/ops/pallas/onehot_gather.py:
`onehot_gather_fwd_pallas` (K1-fwd) and `onehot_scatter_bwd_pallas`
(K1-bwd). The TPU kernels multiply by a one-hot matrix built in VMEM, whose
row holds a point's four corner weights rounded to the map's dtype; these
compute the same function directly:
  out[b, p] = sum_q rw[b, p, q] * flat[b, idx[b, p, q]]     (float32)
  gF[b, k]  = sum_{p, q: idx[b, p, q] == k} rw[b, p, q] * g[b, p]
with rw the weight rounded to the map's dtype, the products and sums in
float32, the corners in order (y0x0, y0x1, y1x0, y1x1). The kernels
(csrc/onehot_gather.cu) say in their header what bounds them; the scatter
uses no atomics, so it repeats bit for bit. The differentiable entry point is
`ops/pixel_gather.gather_bilinear_onehot`.

Dispatch is by device: a CUDA tensor launches the kernel (or raises), a CPU
tensor takes the plain version.
"""

import torch

from .build import check_cuda_tensor, dispatch, load_kernels, stream_of

MAX_TEXELS = 1240  # K1-bwd keeps a 32-channel slice of the whole map in shared memory


def onehot_gather_fwd_plain(flat: torch.Tensor, idx: torch.Tensor,
                            w4: torch.Tensor) -> torch.Tensor:
    """flat [B, K, C]; idx [B, N, 4] corner ids; w4 [B, N, 4] corner weights
    -> [B, N, C] float32."""
    c = flat.shape[-1]
    rw = w4.to(flat.dtype).float()
    out = None
    for q in range(4):
        rows = torch.gather(flat, 1, idx[..., q:q + 1].expand(-1, -1, c)).float()
        term = rw[..., q:q + 1] * rows
        out = term if out is None else out + term
    return out


def onehot_scatter_bwd_plain(g: torch.Tensor, idx: torch.Tensor, w4: torch.Tensor,
                             k: int) -> torch.Tensor:
    """Transposed gather: g [B, N, C] point gradients -> [B, K, C] float32
    map gradient (the weights rounded to g's dtype)."""
    b, _, c = g.shape
    rw = w4.to(g.dtype).float()
    gf = g.float()
    out = torch.zeros((b, k, c), dtype=torch.float32, device=g.device)
    for q in range(4):
        out.scatter_add_(1, idx[..., q:q + 1].expand(-1, -1, c), rw[..., q:q + 1] * gf)
    return out


def _check_points(name, idx, w4, b, n):
    if tuple(idx.shape) != (b, n, 4) or tuple(w4.shape) != (b, n, 4):
        raise ValueError(f"{name}: idx and w4 must be [{b}, {n}, 4], got "
                         f"{tuple(idx.shape)}, {tuple(w4.shape)}")
    idx = idx.to(torch.int64).contiguous()
    w4 = w4.to(torch.float32).contiguous()
    check_cuda_tensor(idx, f"{name} idx", torch.int64, 3)
    check_cuda_tensor(w4, f"{name} w4", torch.float32, 3)
    return idx, w4


def _dtype_flag(name, t):
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: expected bfloat16 or float32, got {t.dtype}")
    return int(t.dtype == torch.float32)


def _onehot_gather_fwd_cuda(flat, idx, w4):
    if flat.dim() != 3:
        raise ValueError(f"K1-fwd: expected flat [B, K, C], got {tuple(flat.shape)}")
    flat = flat.contiguous()
    b, k, c = flat.shape
    is_f32 = _dtype_flag("K1-fwd flat", flat)
    check_cuda_tensor(flat, "K1-fwd flat", flat.dtype, 3)
    n = idx.shape[1]
    idx, w4 = _check_points("K1-fwd", idx, w4, b, n)
    out = torch.empty((b, n, c), dtype=torch.float32, device=flat.device)
    if out.numel() == 0:
        return out
    lib = load_kernels()
    with torch.cuda.device(flat.device):
        onehot_gather_fwd.launches += 1
        lib.call("njf_onehot_gather_fwd", flat.data_ptr(), idx.data_ptr(), w4.data_ptr(),
                 out.data_ptr(), b, k, c, n, is_f32, stream_of(flat))
    return out


def onehot_gather_fwd(flat: torch.Tensor, idx: torch.Tensor, w4: torch.Tensor) -> torch.Tensor:
    """K1-fwd wrapper (same signature as the plain version)."""
    return dispatch("onehot_gather_fwd", flat, lambda: _onehot_gather_fwd_cuda(flat, idx, w4),
                    lambda: onehot_gather_fwd_plain(flat, idx, w4))


def _onehot_scatter_bwd_cuda(g, idx, w4, k):
    if g.dim() != 3:
        raise ValueError(f"K1-bwd: expected g [B, N, C], got {tuple(g.shape)}")
    if not 0 < k <= MAX_TEXELS:
        raise ValueError(f"K1-bwd takes maps of 1..{MAX_TEXELS} texels, got {k}")
    g = g.contiguous()
    b, n, c = g.shape
    is_f32 = _dtype_flag("K1-bwd g", g)
    check_cuda_tensor(g, "K1-bwd g", g.dtype, 3)
    idx, w4 = _check_points("K1-bwd", idx, w4, b, n)
    dev = g.device
    out = torch.empty((b, k, c), dtype=torch.float32, device=dev)
    if n == 0 or c == 0:
        return out.zero_()
    # point ranges per (image, 32-channel slice): about three blocks per SM
    # (one block fits an SM), each range at least 1024 points
    slices = -(-c // 32)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = max(1, min(-(-3 * sms // (b * slices)), n // 1024))
    part = (torch.empty((b, splits, k, c), dtype=torch.float32, device=dev) if splits > 1
            else out)
    lib = load_kernels()
    with torch.cuda.device(dev):
        onehot_scatter_bwd.launches += 1
        lib.call("njf_onehot_scatter_bwd", g.data_ptr(), idx.data_ptr(), w4.data_ptr(),
                 part.data_ptr(), out.data_ptr(), b, k, c, n, splits, is_f32, stream_of(g))
    return out


def onehot_scatter_bwd(g: torch.Tensor, idx: torch.Tensor, w4: torch.Tensor,
                       k: int) -> torch.Tensor:
    """K1-bwd wrapper (same signature as the plain version)."""
    return dispatch("onehot_scatter_bwd", g, lambda: _onehot_scatter_bwd_cuda(g, idx, w4, k),
                    lambda: onehot_scatter_bwd_plain(g, idx, w4, k))


onehot_gather_fwd.launches = 0
onehot_scatter_bwd.launches = 0
