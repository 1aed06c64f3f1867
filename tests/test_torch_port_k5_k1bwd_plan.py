"""K5 (PDF resampling) and K1-bwd (the coarse level's gradient scatter): the
Hopper kernels' orders of operations, emulated in torch on the CPU.

K5 (csrc/pdf_resample.cu) gives each ray one warp: lane l holds
min(8, ceil(S / 32)) consecutive padded weights of a segment, the normaliser
is the lanes' in-order sums added by a fixed xor butterfly, the CDF the
lanes' running sums plus a 5-step shuffle-up scan of the lane totals, then
clamped at 1. `k5_emulate` repeats those float32 roundings and is held
against the plain version and the JAX kernel (Pallas interpret mode), with
empty rays and queries on CDF values (bin ties).

K1-bwd (csrc/onehot_gather.cu) sorts each image's corner entries by texel
(tiles, an exclusive scan over (texel, tile), stable in-tile ranks), sums
pieces of `bwd_plan(...).piece` entries of the sorted list, and adds a
texel's pieces in order. Here: the plan's tiles and pieces cover every entry
once, in (texel, point, corner) order, and size the scratch; `k1_emulate`
is held bit for bit against a float32 loop that sums in the same order, and
within float32 reordering against the plain version and
`onehot_scatter_bwd_pallas` (interpret mode) at 30x40 and 45x80 maps with a
hot texel and untouched ones; both wrappers' arguments through a fake
library. 
K1-bwd-rows (njf_row_scatter, planned by `rows_plan`) sorts each tile's
entries by block of texels, then each (texel block, image) thread block
sorts its block's entries by texel and sums each texel's entries from 0 in
entry order, a texel with more than the plan's piece in at most
`ROWS_PIECES` (32) pieces added in order. `rows_emulate` is that order, held bit for bit against a
float32 loop, against the plain version (bit for bit on rows that are not
cut) and against JAX's `_gather_packed_bwd`; `rows_stages` emulates the
bucket's and the sort's indexing (tiles, runs, slots, the stable sorts, each
block's range of the sorted list); the plan at the train step's shapes; the
wrapper's arguments through a fake library.

JAX is imported only inside the tests that run it, so the card
tests (tests/test_torch_port_cuda.py) can hold the kernels bit for bit
against these emulations on a machine without JAX.
"""

import contextlib

import numpy as np
import pytest
import torch

from neural_jacobian_field_torch.ops.kernels import onehot_gather as k1
from neural_jacobian_field_torch.ops.kernels import pdf_resample as k5
from neural_jacobian_field_torch.ops.pdf import pdf_queries
from neural_jacobian_field_torch.ops.pixel_gather import _corner_ids

# ---------------------------------------------------------------------- K5


def k5_cdf(weights: torch.Tensor, hp: float = 0.01, eps: float = 1e-5) -> torch.Tensor:
    """The kernel's CDF [n, S + 1] (leading 0) from weights [n, S], float32,
    in its order: per-lane sums, the butterfly, segments in order; the
    lanes' running sums, the shuffle-up scan, prefixes added back, clamped."""
    n, s = weights.shape
    per = 8 if s >= 256 else -(-s // 32)
    seg = 32 * per
    nseg = -(-s // seg)
    mask = (torch.arange(nseg * seg) < s).view(nseg, 32, per)
    v = torch.zeros((n, nseg * seg))
    v[:, :s] = weights + hp
    v = v.view(n, nseg, 32, per)
    part = torch.zeros((n, nseg, 32))
    for j in range(per):
        part = part + v[..., j]
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        part = part + part[..., lanes ^ off]
    w_sum = torch.zeros((n,))
    for sg in range(nseg):
        w_sum = w_sum + part[:, sg, 0]
    padding = torch.clamp(eps - w_sum, min=0.0)
    per_bin = padding / s
    w_sum = w_sum + padding
    pdf = torch.where(mask, (v + per_bin[:, None, None, None]) / w_sum[:, None, None, None], 0.0)
    loc, run = torch.zeros_like(pdf), torch.zeros((n, nseg, 32))
    for j in range(per):
        run = run + pdf[..., j]
        loc[..., j] = run
    incl = run
    for off in (1, 2, 4, 8, 16):
        incl = torch.cat([incl[..., :off], incl[..., off:] + incl[..., :-off]], dim=-1)
    excl = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]], dim=-1)
    carry, cdf = torch.zeros((n,)), torch.zeros_like(loc)
    for sg in range(nseg):
        base = carry[:, None] + excl[:, sg]
        cdf[:, sg] = torch.clamp(base[..., None] + loc[:, sg], max=1.0)
        carry = carry + incl[:, sg, 31]
    return torch.cat([torch.zeros((n, 1)), cdf.reshape(n, -1)[:, :s]], dim=-1)


def k5_emulate(bins, weights, u, hp=0.01, eps=1e-5):
    """The kernel's output: its CDF, searchsorted-right, the interpolation."""
    cdf = k5_cdf(weights, hp, eps)
    s = weights.shape[-1]
    inds = torch.searchsorted(cdf, u, right=True)
    below, above = (inds - 1).clamp(0, s), inds.clamp(0, s)
    c0, c1 = cdf.gather(-1, below), cdf.gather(-1, above)
    e0, e1 = bins.gather(-1, below), bins.gather(-1, above)
    denom = c1 - c0
    t = torch.where(denom > 0, (u - c0) / torch.where(denom > 0, denom, 1.0), 0.0)
    return e0 + t.clamp(0.0, 1.0) * (e1 - e0)


def _k5_case(seed, n, s):
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.uniform(size=(n, s + 1)), axis=-1).astype(np.float32)
    weights = rng.uniform(size=(n, s)).astype(np.float32)
    return torch.from_numpy(bins), torch.from_numpy(weights)


@pytest.mark.parametrize("s", [16, 48, 255, 256])
@pytest.mark.parametrize("q", [9, "s+1"])
def test_k5_emulation_matches_plain_and_pallas(s, q):
    """Same numpy inputs, the serving path's queries (stratified=False): the
    kernel's order against the plain version (a sequential cumsum) and the
    JAX kernel in interpret mode (a triangular matmul), 1e-4: CDFs summed in
    other orders, divided by a bin's pdf; these random weights put no query
    on a bin tie (the largest difference is ~1e-5)."""
    import jax
    import jax.numpy as jnp

    from neural_jacobian_field_tpu.ops.pallas.pdf_resample import fused_sample_pdf

    q = s + 1 if q == "s+1" else q
    bins, weights = _k5_case(s, 3, s)
    u = pdf_queries((3,), q - 1, stratified=False)
    got = k5_emulate(bins, weights, u)
    want = k5.fused_sample_pdf_plain(bins, weights, u)
    jax_out = torch.from_numpy(np.array(fused_sample_pdf(
        jax.random.PRNGKey(0), jnp.asarray(bins.numpy()), jnp.asarray(weights.numpy()),
        num_samples=q - 1, stratified=False, interpret=True)))
    assert got.shape == want.shape == jax_out.shape == (3, q)
    for ref in (want, jax_out):
        assert (got - ref).abs().max() <= 1e-4


@pytest.mark.parametrize("s", [16, 48, 255, 256])
def test_k5_emulation_empty_rays(s):
    """All-zero weights: with histogram padding 0 the eps pad alone makes the
    pdf uniform (1 / S in every bin); with the default padding it is uniform
    too. Both within 1e-6 of the plain version (the CDF steps are exact
    up to one rounding each)."""
    bins, _ = _k5_case(7, 4, s)
    weights = torch.zeros((4, s))
    u = pdf_queries((4,), s, stratified=True, generator=torch.Generator().manual_seed(s))
    for hp in (0.0, 0.01):
        got = k5_emulate(bins, weights, u, hp=hp)
        want = k5.fused_sample_pdf_plain(bins, weights, u, histogram_padding=hp)
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= 1e-6
        cdf = k5_cdf(weights, hp=hp)
        assert (cdf[:, -1] - 1.0).abs().max() <= 1e-6 and (cdf <= 1.0).all()


@pytest.mark.parametrize("s", [16, 64, 256])
def test_k5_emulation_tie_queries(s):
    """Queries exactly on CDF values. Power-of-two weights without padding:
    every CDF value is exact in both orders, so the results are equal.
    Random weights, queries on the plain version's CDF: a query may resolve
    to the adjacent bin, within the bin-tie tolerance."""
    bins, weights = _k5_case(11, 3, s)
    exact = torch.full((3, s), 0.5)
    cdf = torch.linspace(0, 1, s + 1).expand(3, -1).contiguous()
    assert torch.equal(k5_cdf(exact, hp=0.0), cdf)
    assert torch.equal(k5_emulate(bins, exact, cdf, hp=0.0),
                       k5.fused_sample_pdf_plain(bins, exact, cdf, histogram_padding=0.0))
    w = weights + 0.01
    plain_cdf = torch.cat([torch.zeros((3, 1)),
                           torch.clamp(torch.cumsum(w / w.sum(-1, keepdim=True), -1), max=1.0)],
                          dim=-1)
    got, want = k5_emulate(bins, weights, plain_cdf), k5.fused_sample_pdf_plain(bins, weights,
                                                                                plain_cdf)
    err = (got - want).abs()
    assert err.max() <= torch.diff(bins, dim=-1).max()
    assert float((err > 1e-4).float().mean()) <= 0.25  # the ties are every query here


# ------------------------------------------------------------------ K1-bwd

_PLANS = [(7, 65536, 1200, 256), (7, 65536, 3600, 256), (2, 2048, 1200, 8),
          (1, 1500, 3600, 6), (2, 333, 6, 40), (1, 10, 1, 32), (1, 4000, 20000, 8),
          (3, 700, 2_000_000, 16)]


@pytest.mark.parametrize("b,n,k,c", _PLANS)
def test_bwd_plan_sizes(b, n, k, c):
    """Tiles of at most 4096 entries (a multiple of 32) cover 4n once with
    K x tiles within the counter cap; pieces cover 4n with 24 warps per SM
    and image where the piece can shrink to 64; the scratch is the counters, row
    pointers and ids (int32) and two partial rows per piece (float32)."""
    plan = k1.bwd_plan(b, n, k, c)
    e = 4 * n
    assert plan.entries == e and plan.tile % 32 == 0
    assert (plan.tiles - 1) * plan.tile < e <= plan.tiles * plan.tile
    assert plan.tile <= 4096 or k * (plan.tiles + 1) > k1.COUNTERS
    assert k * plan.tiles <= max(k1.COUNTERS, k)
    assert plan.smem_hist == (k <= k1.SMEM_TEXELS)
    assert plan.piece in (64, 128, 256, 512, 1024, 2048)
    assert (plan.pieces - 1) * plan.piece < e <= plan.pieces * plan.piece
    assert plan.pieces >= 24 * k1.SMS or plan.piece == 64
    assert plan.int_elems == b * plan.tiles * k + b * (k + 1) + b * e
    assert plan.part_elems == b * plan.pieces * 2 * c
    if (b, n, k) == (7, 65536, 1200):  # the train step's coarse level
        assert (plan.tile, plan.tiles, plan.piece) == (4096, 64, 64)


def bucket(keys: np.ndarray, k: int, plan) -> tuple:
    """One image's bucket stage as the kernels run it: per-tile counts, the
    exclusive scan over (texel, tile), then each tile's entries placed at
    their texel's running position in entry order. -> (row pointers [k + 1],
    entry ids in CSR order)."""
    e = keys.shape[0]
    cnt = np.stack([np.bincount(keys[t * plan.tile:(t + 1) * plan.tile], minlength=k)
                    for t in range(plan.tiles)])
    rowptr = np.concatenate([[0], np.cumsum(cnt.sum(0))])
    cur = rowptr[:-1][None, :] + np.cumsum(cnt, 0) - cnt
    ent = np.full(e, -1)
    for t in range(plan.tiles):
        for i in range(t * plan.tile, min(e, (t + 1) * plan.tile)):
            ent[cur[t, keys[i]]] = i
            cur[t, keys[i]] += 1
    return rowptr, ent


@pytest.mark.parametrize("n,hc,wc,hot", [(1500, 5, 7, 0), (700, 30, 40, 300), (2100, 45, 80, 0)])
def test_bucket_covers_every_entry_once_in_order(n, hc, wc, hot):
    """The CSR list holds every entry once, grouped by texel in (point,
    corner) order; every piece holds at most `piece` entries."""
    rng = np.random.default_rng(n)
    cx = torch.from_numpy(rng.uniform(-2, wc + 1, size=(1, n)).astype(np.float32))
    cy = torch.from_numpy(rng.uniform(-2, hc + 1, size=(1, n)).astype(np.float32))
    cx[:, :hot], cy[:, :hot] = 2.5, 1.25
    idx, _ = _corner_ids(cx, cy, wc, hc)
    keys = idx.reshape(-1).numpy()
    plan = k1.bwd_plan(1, n, hc * wc, 8)
    rowptr, ent = bucket(keys, hc * wc, plan)
    assert sorted(ent) == list(range(4 * n))
    assert ent.tolist() == sorted(range(4 * n), key=lambda i: (keys[i], i))
    assert all(np.all(keys[ent[rowptr[kk]:rowptr[kk + 1]]] == kk) for kk in range(hc * wc))
    cuts = np.arange(0, 4 * n + plan.piece, plan.piece)
    assert np.diff(np.minimum(cuts, 4 * n)).max() <= plan.piece


def k1_emulate(g, idx, w4, k, plan) -> torch.Tensor:
    """The kernels' gF [b, k, c] float32, vectorised: the CSR order (a
    stable sort), each texel's runs inside a piece summed in list order, a
    texel's runs added in piece order. idx [b, n, 4] corner ids, w4 [b, n, 4]
    their weights."""
    b, n, c = g.shape
    e, length = 4 * n, plan.piece
    rw = w4.to(g.dtype).float().reshape(b, e)
    keys = idx.reshape(b, e)
    order = torch.sort(keys, dim=1, stable=True).indices
    tex = torch.gather(keys, 1, order)
    pos = torch.arange(e).repeat(b)
    start = ((pos % length == 0)
             | torch.cat([torch.ones((b, 1), dtype=torch.bool), tex[:, 1:] != tex[:, :-1]],
                         1).reshape(-1))
    run_id = torch.cumsum(start, 0) - 1
    rows = g.float()[torch.arange(b)[:, None], order // 4]
    prod = (rw.gather(1, order)[..., None] * rows).reshape(b * e, c)
    runs = torch.zeros((int(run_id[-1]) + 1, c))
    for j in range(length):
        sel = pos % length == j
        r = run_id[sel]
        runs[r] = torch.where(start[sel][:, None], prod[sel], runs[r] + prod[sel])
    run_tex = (tex.reshape(-1) + k * torch.arange(b).repeat_interleave(e))[start]
    first = torch.cat([torch.ones(1, dtype=torch.bool), run_tex[1:] != run_tex[:-1]])
    at = torch.arange(len(run_tex))
    rank = at - torch.cummax(torch.where(first, at, 0), 0).values
    out = torch.zeros((b * k, c))
    for m in range(int(rank.max()) + 1):
        sel = rank == m
        out[run_tex[sel]] = runs[sel] if m == 0 else out[run_tex[sel]] + runs[sel]
    return out.reshape(b, k, c)


def _k1_case(seed, b, n, hc, wc, c, dtype, hot=0):
    """Corner ids and weights of points spread over (and past) the map, the
    first `hot` points of each image on one spot; g [b, n, c]."""
    rng = np.random.default_rng(seed)
    cx = torch.from_numpy(rng.uniform(-2, wc + 1, size=(b, n)).astype(np.float32))
    cy = torch.from_numpy(rng.uniform(-2, hc + 1, size=(b, n)).astype(np.float32))
    cx[:, :hot], cy[:, :hot] = 3.3, 4.6
    idx, w4 = _corner_ids(cx, cy, wc, hc)
    g = torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32)).to(dtype)
    return g, idx, w4


@pytest.mark.parametrize("b,n,hc,wc,c,dtype,hot", [
    (2, 300, 5, 7, 6, torch.float32, 0),
    (1, 500, 4, 6, 5, torch.bfloat16, 200),   # a texel over several pieces
    (2, 64, 2, 3, 3, torch.bfloat16, 64),     # every point on one spot
])
def test_k1_emulation_is_the_ordered_sum(b, n, hc, wc, c, dtype, hot):
    """Bit for bit: a float32 loop over each texel's entries in (point,
    corner) order, summed piece by piece (the CSR positions // piece), the
    pieces added in order; untouched texels zero."""
    g, idx, w4 = _k1_case(3, b, n, hc, wc, c, dtype, hot)
    k = hc * wc
    plan = k1.bwd_plan(b, n, k, c)
    rw = w4.to(dtype).float().numpy().astype(np.float32)
    gf, ids = g.float().numpy(), idx.numpy()
    want = np.zeros((b, k, c), np.float32)
    for bi in range(b):
        keys = ids[bi].reshape(-1)
        rowptr, ent = bucket(keys, k, plan)
        for kk in range(k):
            total, piece_sum, cur = None, None, None
            for pos in range(rowptr[kk], rowptr[kk + 1]):
                p, q = divmod(int(ent[pos]), 4)
                prod = np.float32(rw[bi, p, q]) * gf[bi, p]
                if pos // plan.piece != cur:
                    if piece_sum is not None:
                        total = piece_sum if total is None else total + piece_sum
                    piece_sum, cur = prod, pos // plan.piece
                else:
                    piece_sum = piece_sum + prod
            if piece_sum is not None:
                want[bi, kk] = piece_sum if total is None else total + piece_sum
    got = k1_emulate(g, idx, w4, k, plan)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("hc,wc", [(30, 40), (45, 80)])
def test_k1_emulation_matches_plain_and_pallas(hc, wc):
    """At the coarse level of a 480x640 image and of a 720x1280 one, bf16 g, a hot texel whose entries span
    several pieces and texels no point touches: the emulation against the
    plain version and onehot_scatter_bwd_pallas (interpret mode), 1e-5 of
    scale (float32 sums reordered); untouched texels exactly zero."""
    import jax.numpy as jnp

    from neural_jacobian_field_tpu.ops.pallas.onehot_gather import onehot_scatter_bwd_pallas

    b, n, c, k = 2, 1024, 8, hc * wc
    g, idx, w4 = _k1_case(5, b, n, hc, wc, c, torch.bfloat16, hot=300)
    plan = k1.bwd_plan(b, n, k, c)
    assert 4 * 300 > 2 * plan.piece  # the hot corners span three pieces or more
    got = k1_emulate(g, idx, w4, k, plan)
    want = k1.onehot_scatter_bwd_plain(g, idx, w4, k)
    jax_out = torch.from_numpy(np.array(onehot_scatter_bwd_pallas(
        jnp.asarray(g.float().numpy(), jnp.bfloat16), jnp.asarray(idx.numpy()),
        jnp.asarray(w4.numpy()), k, interpret=True)))
    untouched = want.abs().sum(-1) == 0
    assert int(untouched.sum()) > 0
    assert not got[untouched].any()
    for ref in (want, jax_out):
        assert got.shape == ref.shape == (b, k, c)
        assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5


# ------------------------------------------------------------- K1-bwd-rows


def rows_emulate(g, idx, w, k, piece) -> torch.Tensor:
    """K1-bwd-rows' output [b, k, c] in g's dtype, vectorised in its order:
    each row's entries (point, then slot) in entry order; a row with cnt <=
    piece entries summed from 0 in that order (the plain version's sum), one
    with more in P = ceil(cnt / L) pieces of L = max(piece, ceil(cnt / 32))
    entries, each summed from 0, the piece sums added from 0 in piece order;
    the float32 sums rounded once to g's dtype. idx [b or 1, n, q]; w shaped
    as idx, or None (unit weights)."""
    b, n, c = g.shape
    q = idx.shape[-1]
    e = q * n
    keys = idx.reshape(-1, e).expand(b, e)
    order = torch.sort(keys, dim=1, stable=True).indices
    prod = g.float()[torch.arange(b)[:, None], order // q]
    if w is not None:
        rw = w.to(g.dtype).float().reshape(-1, e).expand(b, e)
        prod = rw.gather(1, order)[..., None] * prod
    tex = (keys.gather(1, order) + k * torch.arange(b)[:, None]).reshape(-1)
    prod = prod.reshape(b * e, c)
    counts = torch.bincount(tex, minlength=b * k)
    length = torch.clamp(-(-counts // k1.ROWS_PIECES), min=piece)[tex]
    pos = torch.arange(b * e) - (torch.cumsum(counts, 0) - counts)[tex]
    # the (row, piece) pairs in order, and each entry's place in its piece
    pieces, at = torch.unique(tex * k1.ROWS_PIECES + pos // length, return_inverse=True)
    within = pos % length
    sums = torch.zeros((len(pieces), c))
    for j in range(int(within.max()) + 1):
        sel = within == j
        sums[at[sel]] = sums[at[sel]] + prod[sel]
    out = torch.zeros((b * k, c))
    for i in range(k1.ROWS_PIECES):
        sel = pieces % k1.ROWS_PIECES == i
        rows = pieces[sel] // k1.ROWS_PIECES
        out[rows] = out[rows] + sums[sel]
    return out.view(b, k, c).to(g.dtype)


def rows_loop(g, idx, w, k, piece) -> torch.Tensor:
    """The same function as a float32 loop over each row's entries, one
    piece after another (numpy)."""
    b, n, c = g.shape
    q = idx.shape[-1]
    gf = g.float().numpy()
    ids = idx.numpy().reshape(idx.shape[0], -1)
    rw = None if w is None else w.to(g.dtype).float().numpy().reshape(w.shape[0], -1)
    out = np.zeros((b, k, c), np.float32)
    for bi in range(b):
        t = bi if ids.shape[0] > 1 else 0
        for kk in np.unique(ids[t]):
            ent = np.flatnonzero(ids[t] == kk)
            length = max(piece, -(-len(ent) // k1.ROWS_PIECES))
            total = np.zeros(c, np.float32)
            for s0 in range(0, len(ent), length):
                acc = np.zeros(c, np.float32)
                for e in ent[s0:s0 + length]:
                    acc = acc + (gf[bi, e // q] if rw is None else rw[t, e] * gf[bi, e // q])
                total = total + acc
            out[bi, kk] = total
    return torch.from_numpy(out).to(g.dtype)


def rows_stages(keys: np.ndarray, k: int, plan) -> tuple:
    """One table's bucket and sort kernels as they index: rows_bucket sorts
    each tile's entries by texel block, stably, into the tile's slots of the
    list and writes tstart[blk, tile]; rows_sort scans its block's row over
    the tiles (pre, sbase), maps its list positions to slots, sorts the
    list by texel, stably, and writes it from base = the row's sum (the
    entries of lower blocks). -> (the sorted ids [qn], each texel's first
    position [blocks, tb + 1], every block's slots [blocks] lists)."""
    tb, e = 1 << plan.log_tb, len(keys)
    lst = np.full(e, -1)
    tstart = np.zeros((plan.blocks + 1, plan.tiles), int)
    for t in range(plan.tiles):
        seg = np.arange(t * plan.tile, min(e, (t + 1) * plan.tile))
        blk = keys[seg] >> plan.log_tb
        lst[seg] = seg[np.argsort(blk, kind="stable")]
        counts = np.bincount(blk, minlength=plan.blocks)
        tstart[:-1, t] = np.cumsum(counts) - counts
        tstart[-1, t] = len(seg)
    out, tex, slots_of = np.full(e, -1), np.zeros((plan.blocks, tb + 1), int), []
    for blk in range(plan.blocks):
        run = tstart[blk + 1] - tstart[blk]
        pre = np.concatenate([[0], np.cumsum(run)])
        sbase = np.arange(plan.tiles) * plan.tile + tstart[blk]
        base, m = int(tstart[blk].sum()), int(pre[-1])
        tile_of = np.searchsorted(pre, np.arange(m), side="right") - 1  # the last pre <= p
        slots = sbase[tile_of] + np.arange(m) - pre[tile_of]
        block = lst[slots]
        r = keys[block] - blk * tb
        out[base:base + m] = block[np.argsort(r, kind="stable")]
        tex[blk] = base + np.concatenate([[0], np.cumsum(np.bincount(r, minlength=tb))])
        slots_of.append(slots)
    return out, tex, slots_of


# the train step's calls (ops/deterministic._GatherRows.backward): the exact
# mode's fine and mid levels, the fine, mid and coarse knots; the interlevel
# loss's rows (small_scatter's on the main path) and the 2x upsampling's
# corners on one table (both only through chip_smoke's route lines)
_ROWS_PLANS = [(7, 65536, 76800, 512, 1, False), (7, 65536, 4800, 512, 1, False),
               (7, 16384, 76800, 512, 1, False), (7, 4096, 4800, 512, 1, False),
               (7, 2048, 1200, 1024, 1, False), (1792, 512, 257, 1, 1, False),
               (7, 76800, 19200, 64, 4, True), (4, 4096, 768, 128, 1, False)]


def _rows_case(seed, b, n, k, c, dtype, q=1, hot=0, weighted=False, shared=False):
    """Ids spread over the rows (a fifth of them, in runs, untouched), the
    first `hot` entries of each table on row k // 2; g [b, n, c]."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, k, size=(1 if shared else b, n, q))
    idx[(idx // 7) % 5 == 0] //= 3  # rows in runs of 7 that no entry takes, above k / 3
    idx.reshape(idx.shape[0], -1)[:, :hot] = k // 2
    w = (torch.from_numpy(rng.uniform(-1, 1, size=idx.shape).astype(np.float32))
         if weighted else None)
    g = torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32)).to(dtype)
    return g, torch.from_numpy(idx), w


@pytest.mark.parametrize("b,n,k,c,dtype,hot,q,weighted,shared,tol", [
    (2, 700, 9, 6, torch.float32, 0, 1, False, False, 1e-6),
    (1, 900, 5, 5, torch.bfloat16, 400, 1, False, False, 1e-6),  # a row over several pieces
    (2, 3000, 257, 1, torch.float32, 0, 1, False, False, 1e-6),  # the interlevel loss's rows
    (1, 20000, 15000, 3, torch.bfloat16, 1500, 1, False, False, 1e-6),  # k > 12,288; 12 pieces
    (1, 9000, 50, 4, torch.float32, 8000, 1, False, False, 1e-5),  # 32 pieces of 250
    (3, 400, 60, 7, torch.float32, 300, 4, True, True, 1e-6),    # corners, weights, one table
    (2, 2500, 4000, 16, torch.bfloat16, 0, 1, False, False, 1e-6),  # no row cut: all plain
])
def test_row_scatter_emulation_q1_is_the_ordered_sum(b, n, k, c, dtype, hot, q, weighted,
                                                     shared, tol):
    """The emulation bit for bit a float32 loop over each row's entries in
    entry order, a row with more than the plan's piece entries cut into
    pieces added in order; against the plain version (index_add_ from 0 in
    entry order) within 1e-6 of scale (1e-5 where one row sums 8,000 terms:
    float32 reordering grows as the root of the terms, about 5e-6 there),
    bit for bit on every row that is not cut, untouched rows exactly zero;
    in g's dtype."""
    g, idx, w = _rows_case(11, b, n, k, c, dtype, q, hot, weighted, shared)
    piece = k1.rows_plan(b, n, k, c, q=q, shared=shared).piece
    assert hot == 0 or hot > piece
    got = rows_emulate(g, idx, w, k, piece)
    assert got.dtype == dtype and got.shape == (b, k, c)
    assert torch.equal(got, rows_loop(g, idx, w, k, piece))
    sums = rows_emulate(g.float(), idx, None if w is None else w.to(dtype).float(), k, piece)
    plain = k1.row_scatter_plain(g.float(), idx, None if w is None else w.to(dtype).float(), k)
    assert float((sums - plain).abs().max() / plain.abs().max()) <= tol
    counts = torch.stack([torch.bincount(t.reshape(-1), minlength=k)
                          for t in idx.expand(b, -1, -1)])
    whole = counts <= piece
    assert torch.equal(got[whole], k1.row_scatter_plain(g, idx, w, k)[whole])
    assert hot == 0 or bool((counts > piece).any())
    assert not got[counts == 0].any() and bool((counts == 0).any())


@pytest.mark.parametrize("hot", [0, 900])
def test_rows_emulation_matches_jax_gather_packed_bwd(hot):
    """The packed-row gather's gradient on the CPU: JAX's _gather_packed_bwd
    (XLA's scatter-add, through jax.vjp of gather_packed_rows) against the
    port's gather_packed_rows with its row gradient summed in K1-bwd-rows'
    order: within float32 reordering (1e-6 of scale), float32 maps; with a
    hot row the emulation cuts it into pieces."""
    import jax
    import jax.numpy as jnp

    from neural_jacobian_field_torch.ops.pixel_gather import gather_packed_rows as port_gather
    from neural_jacobian_field_tpu.ops.pixel_gather import gather_packed_rows as jax_gather

    b, n, hw, c = 2, 1500, 300, 8
    rng = np.random.default_rng(31)
    packed = rng.normal(size=(b, hw, 4 * c)).astype(np.float32)
    idx = rng.integers(0, hw, size=(b, n))
    idx[:, :hot] = 17
    w4 = rng.uniform(size=(b, n, 4)).astype(np.float32)
    gy = rng.normal(size=(b, n, c)).astype(np.float32)
    _, vjp = jax.vjp(lambda p: jax_gather(p, jnp.asarray(idx), jnp.asarray(w4)),
                     jnp.asarray(packed))
    want = torch.from_numpy(np.array(vjp(jnp.asarray(gy))[0]))
    ti, tw, tg = torch.from_numpy(idx), torch.from_numpy(w4), torch.from_numpy(gy)
    g_rows = torch.cat([tg * tw[..., cnr:cnr + 1] for cnr in range(4)], dim=-1)  # d out / d rows
    piece = k1.rows_plan(b, n, hw, 4 * c).piece
    got = rows_emulate(g_rows, ti[..., None], None, hw, piece)
    assert (hot > piece) == bool(hot)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-6
    packed_t = torch.from_numpy(packed).requires_grad_(True)
    (port,) = torch.autograd.grad(port_gather(packed_t, ti, tw), packed_t, tg)
    assert float((port - want).abs().max() / want.abs().max()) <= 1e-6


@pytest.mark.parametrize("b,n,k,c,q,shared", _ROWS_PLANS)
def test_bwd_plan_sizes_q1(b, n, k, c, q, shared):
    """rows_plan at the train step's shapes: tiles of 2048 entries, halved
    (to 256 at least) while the tables have fewer tiles than the card's 132
    SMs, cover the q n entries once; each texel block dealt to ROWS_SPLITS
    thread blocks of the sums where the call has ROWS_DEAL_DENSITY entries
    a row and fewer than ROWS_DEAL_CTAS_PER_SM thread blocks per SM (the
    exact mid level, the upsampling's corners), their pieces' counts and
    sums in scratch of their own; texel blocks of 8 to 256
    rows cover k, with the images and the slabs of 256 channels at least
    ROWS_CTAS_PER_SM thread blocks per SM where a block of 8 rows allows
    it, and the largest such block; items hold at most ROWS_ITEM_ENTRIES
    entries on average (one texel at least, a block at most); the bucket's
    and the sort's shared memory fits a block without an opt-in at these
    shapes, the sums' (64 partial rows) three blocks an SM with one;
    the scratch is the lists, the run starts, the sorted ids and the texel
    starts."""
    plan = k1.rows_plan(b, n, k, c, 132, q, shared)
    e, tb, slabs = q * n, 1 << plan.log_tb, -(-c // 256)
    assert plan.entries == e and plan.tables == (1 if shared else b)
    assert plan.tile in (256, 512, 1024, 2048)
    assert (plan.tiles - 1) * plan.tile < e <= plan.tiles * plan.tile
    assert plan.tile == 256 or plan.tables * plan.tiles >= 132
    assert plan.tile == 2048 or plan.tables * -(-e // (2 * plan.tile)) < 132
    assert 8 <= tb <= 256 and (plan.blocks - 1) * tb < k <= plan.blocks * tb
    ctas, entries = k1.ROWS_CTAS_PER_SM * 132, k1.ROWS_ITEM_ENTRIES
    assert b * slabs * plan.blocks >= ctas or tb == 8
    assert tb == 256 or b * slabs * -(-k // (2 * tb)) < ctas
    assert 1 <= plan.item_texels <= tb
    assert plan.item_texels * e <= entries * k or plan.item_texels == 1
    assert plan.item_texels == tb or 2 * plan.item_texels * e > entries * k
    assert plan.piece == k1.ROWS_PIECE
    assert plan.bucket_smem == 2 * 8 * plan.blocks <= 48 * 1024
    assert plan.sort_smem == 4 * (2 * plan.tiles + 1 + 8 * tb) <= 48 * 1024
    assert plan.sum_smem == 4 * (3 * tb + 2) + 4 * 64 * 256 <= 227 * 1024 // 3
    dealt = e >= k1.ROWS_DEAL_DENSITY * k and b * slabs * plan.blocks < (
        k1.ROWS_DEAL_CTAS_PER_SM * 132)
    assert plan.splits == (k1.ROWS_SPLITS if dealt else 1)
    assert plan.int_elems == plan.tables * (2 * e + (plan.blocks + 1) * plan.tiles
                                            + plan.blocks * (tb + 1)) + -(-plan.tables * e // 2) \
        + (b * slabs * k if dealt else 0)
    assert plan.part_elems == (b * slabs * ((e >> 6) + k1.ROWS_PIECES) * 256 if dealt else 0)
    if (b, n, k) == (7, 65536, 76800):  # the exact mode's fine level
        assert (plan.log_tb, plan.blocks, plan.tiles) == (8, 300, 32)


@pytest.mark.parametrize("n,k,q,tile,hot", [(5000, 700, 1, 256, 0), (3000, 20000, 1, 512, 800),
                                            (900, 333, 4, 256, 0), (40000, 76800, 1, 2048, 0)])
def test_rows_stages_sort_every_entry_once_in_order(n, k, q, tile, hot):
    """The bucket's and the sort's indexing, emulated: every block's list
    positions map to slots of its own, covering the table's list once; each
    block writes its ids from the sum of its tstart row, and the whole is
    the ids stably sorted by row; each row's first position is its own."""
    rng = np.random.default_rng(n)
    keys = rng.integers(0, k, size=q * n)
    keys[:hot] = k // 3
    plan = k1.rows_plan(1, n, k, 8, 132, q)._replace(tile=tile, tiles=-(-q * n // tile))
    ids, tex, slots = rows_stages(keys, k, plan)
    assert sorted(np.concatenate(slots).tolist()) == list(range(q * n))
    want = np.argsort(keys, kind="stable")
    assert ids.tolist() == want.tolist()
    first = np.searchsorted(keys[want], np.arange(plan.blocks * (1 << plan.log_tb) + 1))
    assert np.array_equal(tex[:, :-1].reshape(-1), first[:-1])
    assert np.array_equal(tex[:, -1], first[(1 << plan.log_tb)::(1 << plan.log_tb)])


# ---------------------------------------------------------- the wrappers


class _FakeLib:
    def __init__(self):
        self.calls = []

    def call(self, name, *args):
        self.calls.append((name, args))


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' host side on CPU tensors: no device checks, no stream, a
    fake library, a 132-SM card; records what torch.empty allocates."""
    lib, allocs = _FakeLib(), {}
    empty = torch.empty

    def recording_empty(*args, **kw):
        t = empty(*args, **kw)
        allocs[t.data_ptr()] = t
        return t

    for mod in (k1, k5):
        monkeypatch.setattr(mod, "load_kernels", lambda: lib)
        monkeypatch.setattr(mod, "check_cuda_tensor", lambda *a, **kw: None)
        monkeypatch.setattr(mod, "stream_of", lambda t: 0)
        monkeypatch.setattr(mod, "_on_device", lambda t: contextlib.nullcontext())
    monkeypatch.setattr(k1, "_sms", lambda index: 132)
    monkeypatch.setattr(torch, "empty", recording_empty)
    return lib, allocs


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k1_bwd_wrapper_launches_by_the_plan(fake_card, dtype):
    """One call of the entry point with the plan's tiles, pieces and shared
    memory switch, scratch of the plan's sizes, counted once; a 45x80 map
    (3,600 texels) is taken."""
    lib, allocs = fake_card
    b, n, hc, wc, c = 2, 900, 45, 80, 40
    g, idx, w4 = _k1_case(9, b, n, hc, wc, c, dtype)
    n0 = k1.onehot_scatter_bwd.launches
    out = k1._onehot_scatter_bwd_cuda(g, idx, w4, hc * wc)
    assert k1.onehot_scatter_bwd.launches == n0 + 1
    ((name, args),) = lib.calls
    plan = k1.bwd_plan(b, n, hc * wc, c)
    assert name == "njf_onehot_scatter_bwd"
    assert args[0] == g.data_ptr() and args[5] == out.data_ptr()
    assert out.shape == (b, hc * wc, c) and out.dtype == torch.float32
    iscratch, part = allocs[args[3]], allocs[args[4]]
    assert iscratch.dtype == torch.int32 and iscratch.numel() == plan.int_elems
    assert part.dtype == torch.float32 and part.numel() == plan.part_elems
    assert args[6:] == (b, hc * wc, c, n, plan.tile, plan.tiles, plan.piece, 1,
                        int(dtype == torch.float32), 0)


@pytest.mark.parametrize("q,weighted,dtype", [(1, False, torch.bfloat16), (4, True, torch.float32),
                                               (1, True, torch.float32)])
def test_row_scatter_wrapper_launches_by_the_plan(fake_card, q, weighted, dtype):
    """One call of njf_row_scatter with q, the weight switch (a null pointer
    for unit weights) and rows_plan's texel blocks, tiles, piece, items and
    splits, one int32 scratch of the plan's size, a float32 scratch for the
    pieces' sums where the plan deals a block to two thread blocks (a dense
    call on few thread blocks: the corners; else a null pointer), the
    output in g's dtype, counted once."""
    lib, allocs = fake_card
    b, n, k, c = 2, 700, 300, 24
    rng = np.random.default_rng(4)
    idx = torch.from_numpy(rng.integers(0, k, size=(b, n, q)))
    w = torch.from_numpy(rng.uniform(size=(b, n, q)).astype(np.float32)) if weighted else None
    g = torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32)).to(dtype)
    n0 = k1.row_scatter.launches
    out = k1._row_scatter_cuda(g, idx, w, k)
    assert k1.row_scatter.launches == n0 + 1
    ((name, args),) = lib.calls
    plan = k1.rows_plan(b, n, k, c, 132, q)
    assert name == "njf_row_scatter" and plan.entries == q * n and plan.tables == b
    assert args[0] == g.data_ptr() and args[1] == idx.data_ptr() and args[5] == out.data_ptr()
    assert (args[2] != 0) == weighted
    assert out.shape == (b, k, c) and out.dtype == dtype
    iscratch = allocs[args[3]]
    assert iscratch.dtype == torch.int32 and iscratch.numel() == plan.int_elems
    assert plan.splits == (2 if q == 4 else 1)
    if plan.splits > 1:
        part = allocs[args[4]]
        assert part.dtype == torch.float32 and part.numel() == plan.part_elems > 0
    else:
        assert args[4] == 0 and plan.part_elems == 0
    assert args[6:] == (b, k, c, n, q, plan.log_tb, plan.tile, plan.piece, plan.item_texels,
                        plan.splits, int(dtype == torch.float32), int(weighted), 0, 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_row_scatter_wrapper_passes_a_shared_table_once(fake_card, dtype):
    """idx and w [1, N, 4] for B images (the upsampling's corners): passed
    as they are, no copy per image, the shared switch on, one table's list,
    run starts, sorted ids, texel starts and rows in the scratch; the output
    in g's dtype."""
    lib, allocs = fake_card
    b, n, k, c = 3, 640, 160, 16
    rng = np.random.default_rng(6)
    idx = torch.from_numpy(rng.integers(0, k, size=(1, n, 4)))
    w = torch.from_numpy(rng.uniform(size=(1, n, 4)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32)).to(dtype)
    out = k1._row_scatter_cuda(g, idx, w, k)
    ((name, args),) = lib.calls
    plan = k1.rows_plan(b, n, k, c, 132, 4, True)
    assert name == "njf_row_scatter" and args[1] == idx.data_ptr() and args[2] == w.data_ptr()
    assert out.shape == (b, k, c) and out.dtype == dtype
    assert plan.tables == 1 and plan.splits > 1
    assert allocs[args[3]].numel() == plan.int_elems == (
        8 * n + (plan.blocks + 1) * plan.tiles + plan.blocks * ((1 << plan.log_tb) + 1) + 2 * n
        + b * k)
    assert allocs[args[4]].numel() == plan.part_elems == b * ((4 * n >> 6) + 32) * 256
    assert args[6:] == (b, k, c, n, 4, plan.log_tb, plan.tile, plan.piece, plan.item_texels,
                        plan.splits, int(dtype == torch.float32), 1, 1, 0)


def test_k5_wrapper_passes_rows_without_copies(fake_card):
    """Contiguous float32 rows go to the entry point as they are (no copy),
    with S, Q and the paddings; the output takes the inputs' leading shape;
    float64 inputs are converted."""
    lib, _ = fake_card
    bins, weights = _k5_case(1, 6, 48)
    bins, weights = bins.view(2, 3, 49), weights.view(2, 3, 48)
    u = pdf_queries((2, 3), 8, stratified=False)
    n0 = k5.fused_sample_pdf.launches
    out = k5._fused_sample_pdf_cuda(bins, weights, u, 0.02, 1e-6)
    assert k5.fused_sample_pdf.launches == n0 + 1 and out.shape == (2, 3, 9)
    ((name, args),) = lib.calls
    assert name == "njf_pdf_resample"
    assert args[:3] == (bins.data_ptr(), weights.data_ptr(), u.data_ptr())
    assert args[3] == out.data_ptr() and args[4:9] == (6, 48, 9, 0.02, 1e-6)
    k5._fused_sample_pdf_cuda(bins.double(), weights.double(), u, 0.01, 1e-5)
    assert lib.calls[1][1][0] != bins.data_ptr()
