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
(csrc/onehot_gather.cu) say in their header what bounds them. The scatter
sorts the corner entries by texel and sums fixed-length pieces of the sorted
list, then adds the pieces of each texel in order (`bwd_plan` sizes the
stages and the scratch): no floating-point atomics, so it repeats bit for
bit, and no limit on K but int32 entry ids. The differentiable entry point is
`ops/pixel_gather.gather_bilinear_onehot`.

`row_scatter` is the same scatter generalised (njf_row_scatter, K1-bwd-rows):
Q entries per point (1 for a row gather, 4 for bilinear corners), rows of
any width, weights optional, one table of ids for every image or one each,
the output in g's dtype. It is the fixed-order backward of the port's row
gathers (`ops/deterministic.gather_rows`: the pyramid's packed rows, the
epipolar knots, the concat layout's lookups), which would otherwise sum
with atomics (scatter_add_) and differ from run to run on the card.
`small_scatter` (njf_small_scatter, K1-bwd-small, csrc/small_scatter.cu) is
the same function with one entry a point and unit weights for images that
fit a thread block, sorted and summed there in one launch: `small_plan`
admits the shapes (the interlevel loss's per-ray rows), and gather_rows's
backward takes it there and `row_scatter` elsewhere. The encoder's
upsampling has its own backward (`upsample_bwd`, K1-bwd-upsample).

Dispatch is by device: a CUDA tensor launches the kernel (or raises), a CPU
tensor takes the plain version.
"""

import functools
from typing import NamedTuple

import torch

from .build import check_cuda_tensor, dispatch, load_kernels, stream_of
from .conv_suite import SMS, _on_device, _sms

SMEM_TEXELS = 12288  # the bucket's counters in shared memory up to this K
COUNTERS = 1 << 21   # bucket counters per image (K x tiles) at most
MAX_ENTRIES = 1 << 30  # corner entries per image (4N): int32 ids and offsets


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


def row_scatter_plain(g: torch.Tensor, idx: torch.Tensor, w, k: int) -> torch.Tensor:
    """g [B, N, C] point rows; idx [B, N, Q] row ids in [0, k), or [1, N, Q]:
    one table for every image; w shaped as idx, weights, or None (unit) ->
    [B, K, C] in g's dtype: out[b, idx[b, p, q]] += w[b, p, q] * g[b, p],
    summed in float32 (float64 for a float64 g) and rounded once, the
    weights rounded to g's dtype as the kernel rounds them. Each row's terms
    are summed in entry order (p, then q): on the CPU index_add_ adds them
    one after another, so the result repeats bit for bit."""
    b, n, c = g.shape
    q = idx.shape[-1]
    acc = torch.float64 if g.dtype == torch.float64 else torch.float32
    src = g.to(acc)[:, :, None, :].expand(b, n, q, c)
    if w is not None:
        src = w.to(g.dtype).to(acc)[..., None] * src
    rows = (idx + k * torch.arange(b, device=idx.device)[:, None, None]).reshape(-1)
    out = torch.zeros((b * k, c), dtype=acc, device=g.device)
    out.index_add_(0, rows, src.reshape(-1, c))
    return out.view(b, k, c).to(g.dtype)


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


class BwdPlan(NamedTuple):
    """K1-bwd's stages for g [b, n, c] onto k texels (csrc/onehot_gather.cu):
    the bucket sort's tiles of corner entries, the segment pass's pieces of
    the sorted list, and the scratch, in elements."""
    entries: int     # entries per image, q n (4n corners for K1-bwd)
    tile: int        # entries per bucket tile (a multiple of 32)
    tiles: int       # bucket tiles per image
    smem_hist: bool  # the bucket's counters in shared memory
    piece: int       # entries per piece of the segment pass
    pieces: int      # pieces per image
    int_elems: int   # int32: counters [b, tiles, k], row pointers [b, k + 1], ids [b, qn]
    part_elems: int  # float32: two partial rows per piece, [b, pieces, 2, c]


@functools.lru_cache(maxsize=256)
def bwd_plan(b: int, n: int, k: int, c: int, sms: int = SMS, q: int = 4,
             shared: bool = False) -> BwdPlan:
    """shared: one table of ids for every image (sorted once: one image's
    counters, row pointers and ids). Tiles of 4096 entries (fewer, longer ones where K x tiles would pass
    COUNTERS). Pieces: the largest power of two in [64, 2048] that gives an
    image at least 24 warps per SM, more than the card holds at once, so the
    warps in flight work on about one image and its g stays in L2 (the
    pieces are walked image by image)."""
    entries = q * n
    if min(b, n, k, c) <= 0 or q not in (1, 4) or entries > MAX_ENTRIES:
        raise ValueError(f"K1-bwd: b {b}, n {n}, k {k}, c {c}, q {q} (q in 1, 4; qn <= "
                         f"{MAX_ENTRIES})")
    tiles = max(1, min(-(-entries // 4096), COUNTERS // k))
    tile = -(-entries // tiles)
    tile = -(-tile // 32) * 32
    tiles = -(-entries // tile)
    piece = 2048
    while piece > 64 and -(-entries // piece) < 24 * sms:
        piece //= 2
    pieces = -(-entries // piece)
    tables = 1 if shared else b
    return BwdPlan(entries, tile, tiles, k <= SMEM_TEXELS, piece, pieces,
                   tables * (tiles * k + k + 1 + entries), b * pieces * 2 * c)


def _onehot_scatter_bwd_cuda(g, idx, w4, k):
    if g.dim() != 3:
        raise ValueError(f"K1-bwd: expected g [B, N, C], got {tuple(g.shape)}")
    if k <= 0:
        raise ValueError(f"K1-bwd: the map needs texels, got k = {k}")
    g = g.contiguous()
    b, n, c = g.shape
    is_f32 = _dtype_flag("K1-bwd g", g)
    check_cuda_tensor(g, "K1-bwd g", g.dtype, 3)
    idx, w4 = _check_points("K1-bwd", idx, w4, b, n)
    dev = g.device
    if n == 0 or c == 0:
        return torch.zeros((b, k, c), dtype=torch.float32, device=dev)
    plan = bwd_plan(b, n, k, c, _sms(dev.index))
    out = torch.empty((b, k, c), dtype=torch.float32, device=dev)
    iscratch = torch.empty(plan.int_elems, dtype=torch.int32, device=dev)
    part = torch.empty(plan.part_elems, dtype=torch.float32, device=dev)
    lib = load_kernels()
    with _on_device(g):
        onehot_scatter_bwd.launches += 1
        lib.call("njf_onehot_scatter_bwd", g.data_ptr(), idx.data_ptr(), w4.data_ptr(),
                 iscratch.data_ptr(), part.data_ptr(), out.data_ptr(), b, k, c, n, plan.tile,
                 plan.tiles, plan.piece, int(plan.smem_hist), is_f32, stream_of(g))
    return out


def onehot_scatter_bwd(g: torch.Tensor, idx: torch.Tensor, w4: torch.Tensor,
                       k: int) -> torch.Tensor:
    """K1-bwd wrapper (same signature as the plain version)."""
    return dispatch("onehot_scatter_bwd", g, lambda: _onehot_scatter_bwd_cuda(g, idx, w4, k),
                    lambda: onehot_scatter_bwd_plain(g, idx, w4, k))


def _row_scatter_cuda(g, idx, w, k):
    if (g.dim() != 3 or idx.dim() != 3 or idx.shape[1] != g.shape[1]
            or idx.shape[0] not in (1, g.shape[0])):
        raise ValueError(f"row_scatter: expected g [B, N, C] and idx [B, N, Q] or [1, N, Q], "
                         f"got {tuple(g.shape)}, {tuple(idx.shape)}")
    if w is not None and tuple(w.shape) != tuple(idx.shape):
        raise ValueError(f"row_scatter: w must be shaped as idx, got {tuple(w.shape)}")
    if k <= 0:
        raise ValueError(f"row_scatter: the map needs rows, got k = {k}")
    g = g.contiguous()
    b, n, c = g.shape
    q = idx.shape[-1]
    shared = idx.shape[0] == 1 and b > 1
    is_f32 = _dtype_flag("row_scatter g", g)
    check_cuda_tensor(g, "row_scatter g", g.dtype, 3)
    idx = idx.to(torch.int64).contiguous()
    check_cuda_tensor(idx, "row_scatter idx", torch.int64, 3)
    if w is not None:
        w = w.to(torch.float32).contiguous()
        check_cuda_tensor(w, "row_scatter w", torch.float32, 3)
    dev = g.device
    if n == 0 or c == 0:
        return torch.zeros((b, k, c), dtype=g.dtype, device=dev)
    plan = bwd_plan(b, n, k, c, _sms(dev.index), q, shared)
    out = torch.empty((b, k, c), dtype=g.dtype, device=dev)
    iscratch = torch.empty(plan.int_elems, dtype=torch.int32, device=dev)
    part = torch.empty(plan.part_elems, dtype=torch.float32, device=dev)
    lib = load_kernels()
    with _on_device(g):
        row_scatter.launches += 1
        lib.call("njf_row_scatter", g.data_ptr(), idx.data_ptr(),
                 0 if w is None else w.data_ptr(), iscratch.data_ptr(), part.data_ptr(),
                 out.data_ptr(), b, k, c, n, q, plan.tile, plan.tiles, plan.piece,
                 int(plan.smem_hist), is_f32, int(w is not None), int(shared), stream_of(g))
    return out


def row_scatter(g: torch.Tensor, idx: torch.Tensor, w, k: int) -> torch.Tensor:
    """The generalised K1-bwd wrapper (same signature as row_scatter_plain;
    bf16 or float32 g on the card, the output in g's dtype)."""
    return dispatch("row_scatter", g, lambda: _row_scatter_cuda(g, idx, w, k),
                    lambda: row_scatter_plain(g, idx, w, k))


SMALL_ENTRIES = 4096     # entries per image: 16-bit list positions, a short walk
SMALL_MAP = 12288        # k x c per image: a float32 map of 48 KB at most
SMALL_SMEM = 48 * 1024   # the kernel's dynamic shared memory, without an opt-in


@functools.lru_cache(maxsize=256)
def small_plan(n: int, k: int, c: int) -> int | None:
    """K1-bwd-small's dynamic shared memory in bytes (csrc/small_scatter.cu,
    one block an image: ids and row ends int32, the sorted list uint16) for
    images of n entries onto k rows of c channels, or None where the shape
    is not its: more than SMALL_ENTRIES entries, a k x c map above
    SMALL_MAP, or shared memory above SMALL_SMEM. A row gather's backward
    takes K1-bwd-small where this admits its shape, and K1-bwd-rows's
    counting sort elsewhere."""
    if min(n, k, c) <= 0 or n > SMALL_ENTRIES or k * c > SMALL_MAP:
        return None
    smem = -(-(6 * n + 4 * k) // 16) * 16
    return smem if smem <= SMALL_SMEM else None


def small_scatter_plain(g: torch.Tensor, idx: torch.Tensor, k: int) -> torch.Tensor:
    """g [B, N, C], idx [B, N] row ids in [0, k) -> [B, K, C] in g's dtype:
    row_scatter_plain with one entry a point and unit weights (each row's
    entries summed in point order from 0, in float32, rounded once)."""
    return row_scatter_plain(g, idx[..., None], None, k)


def _small_scatter_cuda(g, idx, k):
    if g.dim() != 3 or tuple(idx.shape) != tuple(g.shape[:2]):
        raise ValueError(f"small_scatter: expected g [B, N, C] and idx [B, N], got "
                         f"{tuple(g.shape)}, {tuple(idx.shape)}")
    g = g.contiguous()
    b, n, c = g.shape
    is_f32 = _dtype_flag("small_scatter g", g)
    check_cuda_tensor(g, "small_scatter g", g.dtype, 3)
    if b == 0 or n == 0 or c == 0:
        return torch.zeros((b, k, c), dtype=g.dtype, device=g.device)
    smem = small_plan(n, k, c)
    if smem is None:
        raise ValueError(f"small_scatter: n {n}, k {k}, c {c} is not a shape of small_plan's")
    idx = idx.to(torch.int64).contiguous()
    check_cuda_tensor(idx, "small_scatter idx", torch.int64, 2)
    out = torch.empty((b, k, c), dtype=g.dtype, device=g.device)
    lib = load_kernels()
    with _on_device(g):
        small_scatter.launches += 1
        lib.call("njf_small_scatter", g.data_ptr(), idx.data_ptr(), out.data_ptr(), b, k, c, n,
                 smem, is_f32, stream_of(g))
    return out


def small_scatter(g: torch.Tensor, idx: torch.Tensor, k: int) -> torch.Tensor:
    """K1-bwd-small's wrapper (same signature as small_scatter_plain; bf16
    or float32 g on the card, shapes that small_plan admits)."""
    return dispatch("small_scatter", g, lambda: _small_scatter_cuda(g, idx, k),
                    lambda: small_scatter_plain(g, idx, k))


onehot_gather_fwd.launches = 0
onehot_scatter_bwd.launches = 0
row_scatter.launches = 0
small_scatter.launches = 0
