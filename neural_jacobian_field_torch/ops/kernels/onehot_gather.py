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

`row_scatter` is the same function generalised (njf_row_scatter,
K1-bwd-rows): Q entries per point (1 for a row gather, 4 for bilinear
corners), rows of any width, weights optional, one table of ids for every
image or one each, the output in g's dtype. It is the fixed-order backward
of the port's row gathers (`ops/deterministic.gather_rows`: the pyramid's
packed rows, the epipolar knots, the concat layout's lookups), which would
otherwise sum with atomics (scatter_add_) and differ from run to run on the
card. Its kernels are built for those shapes (`rows_plan`): a stable sort
of each tile of entries by block of texels, a stable sort of each block's
entries by texel, then a thread block per (texel block, image, slab of 256
channels), or two sharing its work in a dense call on few thread blocks,
that writes every row of its block once, each texel's entries
summed from 0 in entry order (bit for bit the plain version) unless it has
more than `rows_plan(...).piece`, then in at most ROWS_PIECES pieces added
in order. `row_scatter_csr` is its previous design, K1-bwd's counting sort
generalised, kept only as the yardstick chip_smoke times beside it.
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
    """q entries per point (4 for K1-bwd; any q for `row_scatter_csr`);
    shared: one table of ids for every image (sorted once: one image's
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


ROWS_WARPS = 8           # warps of a thread block of the sort and the sums
ROWS_PIECE = 128         # a row with more entries is summed in pieces ...
ROWS_PIECES = 32         # ... at most this many, of max(ROWS_PIECE, ceil(cnt / ROWS_PIECES))
ROWS_QUEUED = 64         # pieces a thread block of the sums holds at once
ROWS_TILE = 2048         # entries per bucket tile (more where a table has more than 2048 tiles,
                         # down to 256 where the tables have fewer tiles than the card has SMs)
ROWS_MAX_TILES = 2048    # tiles per table: the sort keeps two ints per tile in shared memory
ROWS_MAX_BLOCKS = 8192   # texel blocks: the bucket keeps 8 x 16-bit counters per block
ROWS_MAX_ENTRIES = 1 << 26  # q n per table: positions in a tile fit 16 bits
ROWS_CTAS_PER_SM = 5     # (texel block, image, slab) thread blocks of the sums per SM
ROWS_ITEM_ENTRIES = 8    # entries a warp's item should hold, on average
ROWS_DEAL_CTAS_PER_SM = 20  # a call with fewer thread blocks of the sums per SM ...
ROWS_DEAL_DENSITY = 4       # ... and at least this many entries a row on average ...
ROWS_SPLITS = 2             # ... deals each texel block to this many (a hot block, two SMs)


class RowsPlan(NamedTuple):
    """K1-bwd-rows' launch for g [b, n, c] onto k rows, q entries a point
    (csrc/onehot_gather.cu, njf_row_scatter): the bucket's tiles, the texel
    blocks, the sums' items and split rows, the shared memory of the three
    kernels and the int32 scratch."""
    entries: int      # entries per table, q n
    tables: int       # tables of ids: b, or 1 shared by the images
    tile: int         # entries per bucket tile (a multiple of 256, at most 32768)
    tiles: int        # tiles per table
    log_tb: int       # texel blocks of 2**log_tb consecutive rows
    blocks: int       # texel blocks, ceil(k / 2**log_tb)
    item_texels: int  # texels per item of the sum pass (a power of two, at most a block)
    piece: int        # a row with more entries is summed in pieces (ROWS_PIECES)
    splits: int       # thread blocks of the sums per (texel block, image, slab)
    bucket_smem: int  # bytes: 16-bit counters [8, blocks]
    sort_smem: int    # bytes: int [tiles + 1], [tiles], [8, tb]
    sum_smem: int     # bytes: int [tb + 1], [tb], 2 x [ROWS_QUEUED]; float [ROWS_QUEUED, 256]
    int_elems: int    # int32: lists [tables, qn], run starts [tables, blocks + 1, tiles],
                      # sorted ids [tables, qn] (by block, then row), row starts
                      # [tables, blocks, tb + 1];
                      # uint16: each listed entry's row in its block [tables, qn];
                      # splits > 1: the pieces' counts [b, slabs, k]
    part_elems: int   # float32, splits > 1: piece sums [b, slabs, (qn >> 6) + 32, 256]


@functools.lru_cache(maxsize=256)
def rows_plan(b: int, n: int, k: int, c: int, sms: int = SMS, q: int = 1,
              shared: bool = False) -> RowsPlan:
    """Texel blocks: the largest of 8 ... 256 rows that gives the images and
    slabs of 256 channels at least ROWS_CTAS_PER_SM thread blocks per SM (8
    rows where none does; larger only where k would pass ROWS_MAX_BLOCKS),
    so that every SM holds several and none waits on another; items: the
    most texels (a power of two) that hold ROWS_ITEM_ENTRIES entries on
    average at these shapes' density, so a warp has rows in flight across
    texels; bucket tiles of ROWS_TILE entries, halved (to 256 at least)
    while the tables have fewer tiles than the card has SMs, so that a
    small call's bucket spreads over the card; each texel block dealt to
    ROWS_SPLITS thread blocks of the sums in a dense call on few thread
    blocks (the mid level's and the lookups' hot rows would hold one SM;
    a sparse call only pays for the extra blocks). shared: one table of
    ids for every image (one bucket pass and one sort; every image's sums
    read them)."""
    entries = q * n
    if min(b, n, k, c) <= 0 or q not in (1, 4) or entries > ROWS_MAX_ENTRIES or b > 65535:
        raise ValueError(f"K1-bwd-rows: b {b}, n {n}, k {k}, c {c}, q {q} (q in 1, 4; qn <= "
                         f"{ROWS_MAX_ENTRIES}; b <= 65535)")
    tables = 1 if shared else b
    tile = max(ROWS_TILE, -(-entries // ROWS_MAX_TILES))
    tile = -(-tile // 256) * 256
    while tile > 256 and tables * -(-entries // tile) < sms:
        tile //= 2
    tiles = -(-entries // tile)
    slabs = -(-c // 256)
    if slabs > 65535:
        raise ValueError(f"K1-bwd-rows: rows of {c} channels")
    log_tb = 8
    while log_tb > 3 and b * slabs * -(-k // (1 << log_tb)) < ROWS_CTAS_PER_SM * sms:
        log_tb -= 1
    while -(-k // (1 << log_tb)) > ROWS_MAX_BLOCKS:
        log_tb += 1
    if log_tb > 10:
        raise ValueError(f"K1-bwd-rows: k {k} rows need blocks above 1024 rows")
    tb = 1 << log_tb
    blocks = -(-k // tb)
    item_texels = 1
    while item_texels < tb and 2 * item_texels * entries <= ROWS_ITEM_ENTRIES * k:
        item_texels *= 2
    dense = entries >= ROWS_DEAL_DENSITY * k
    splits = ROWS_SPLITS if dense and b * slabs * blocks < ROWS_DEAL_CTAS_PER_SM * sms else 1
    return RowsPlan(entries, tables, tile, tiles, log_tb, blocks, item_texels, ROWS_PIECE,
                    splits, 2 * ROWS_WARPS * blocks, 4 * (2 * tiles + 1 + ROWS_WARPS * tb),
                    4 * (3 * tb + 2) + 4 * ROWS_QUEUED * 256,
                    tables * (2 * entries + (blocks + 1) * tiles + blocks * (tb + 1))
                    + -(-tables * entries // 2) + (b * slabs * k if splits > 1 else 0),
                    b * slabs * ((entries >> (ROWS_PIECE.bit_length() - 2)) + ROWS_PIECES) * 256
                    if splits > 1 else 0)


def _rows_args(name, g, idx, w, k):
    """The row scatters' checks: g [B, N, C] bf16 or float32, idx [B, N, Q]
    or [1, N, Q] (one table for every image) int64, w shaped as idx or None,
    contiguous on the card. -> (g, idx, w, shared, is_f32)."""
    if (g.dim() != 3 or idx.dim() != 3 or idx.shape[1] != g.shape[1]
            or idx.shape[0] not in (1, g.shape[0])):
        raise ValueError(f"{name}: expected g [B, N, C] and idx [B, N, Q] or [1, N, Q], "
                         f"got {tuple(g.shape)}, {tuple(idx.shape)}")
    if w is not None and tuple(w.shape) != tuple(idx.shape):
        raise ValueError(f"{name}: w must be shaped as idx, got {tuple(w.shape)}")
    if k <= 0:
        raise ValueError(f"{name}: the map needs rows, got k = {k}")
    g = g.contiguous()
    is_f32 = _dtype_flag(f"{name} g", g)
    check_cuda_tensor(g, f"{name} g", g.dtype, 3)
    idx = idx.to(torch.int64).contiguous()
    check_cuda_tensor(idx, f"{name} idx", torch.int64, 3)
    if w is not None:
        w = w.to(torch.float32).contiguous()
        check_cuda_tensor(w, f"{name} w", torch.float32, 3)
    return g, idx, w, idx.shape[0] == 1 and g.shape[0] > 1, is_f32


def _row_scatter_cuda(g, idx, w, k):
    g, idx, w, shared, is_f32 = _rows_args("row_scatter", g, idx, w, k)
    b, n, c = g.shape
    q = idx.shape[-1]
    dev = g.device
    if b == 0 or n == 0 or c == 0:
        return torch.zeros((b, k, c), dtype=g.dtype, device=dev)
    plan = rows_plan(b, n, k, c, _sms(dev.index), q, shared)
    out = torch.empty((b, k, c), dtype=g.dtype, device=dev)
    iscratch = torch.empty(plan.int_elems, dtype=torch.int32, device=dev)
    part = (torch.empty(plan.part_elems, dtype=torch.float32, device=dev) if plan.part_elems
            else None)
    lib = load_kernels()
    with _on_device(g):
        row_scatter.launches += 1
        lib.call("njf_row_scatter", g.data_ptr(), idx.data_ptr(),
                 0 if w is None else w.data_ptr(), iscratch.data_ptr(),
                 0 if part is None else part.data_ptr(), out.data_ptr(), b, k, c, n, q,
                 plan.log_tb, plan.tile, plan.piece, plan.item_texels, plan.splits, is_f32,
                 int(w is not None), int(shared), stream_of(g))
    return out


def row_scatter(g: torch.Tensor, idx: torch.Tensor, w, k: int) -> torch.Tensor:
    """K1-bwd-rows' wrapper (same signature as row_scatter_plain; bf16 or
    float32 g on the card, the output in g's dtype)."""
    return dispatch("row_scatter", g, lambda: _row_scatter_cuda(g, idx, w, k),
                    lambda: row_scatter_plain(g, idx, w, k))


def row_scatter_csr(g: torch.Tensor, idx: torch.Tensor, w, k: int) -> torch.Tensor:
    """K1-bwd-rows' previous design, K1-bwd's counting sort by texel, piece
    sums and ordered merge for Q entries a point (njf_row_scatter_csr,
    planned by `bwd_plan(..., q, shared)`; the same function, its own
    summation order): the yardstick chip_smoke times beside the kernel. No
    path of the port calls it; CUDA tensors only, uncounted."""
    g, idx, w, shared, is_f32 = _rows_args("row_scatter_csr", g, idx, w, k)
    b, n, c = g.shape
    q = idx.shape[-1]
    dev = g.device
    plan = bwd_plan(b, n, k, c, _sms(dev.index), q, shared)
    out = torch.empty((b, k, c), dtype=g.dtype, device=dev)
    iscratch = torch.empty(plan.int_elems, dtype=torch.int32, device=dev)
    part = torch.empty(plan.part_elems, dtype=torch.float32, device=dev)
    with _on_device(g):
        load_kernels().call(
            "njf_row_scatter_csr", g.data_ptr(), idx.data_ptr(), 0 if w is None else w.data_ptr(),
            iscratch.data_ptr(), part.data_ptr(), out.data_ptr(), b, k, c, n, q, plan.tile,
            plan.tiles, plan.piece, int(plan.smem_hist), is_f32, int(w is not None), int(shared),
            stream_of(g))
    return out


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
