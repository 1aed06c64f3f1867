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
library. JAX is imported only inside the tests that run it, so the card
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
    texel's runs added in piece order. idx [b, n, q]: q = 4 corners (K1-bwd)
    or q = 1 (the generalised scatter, row_scatter); w4 None: unit
    weights."""
    b, n, c = g.shape
    q = idx.shape[-1]
    e, length = q * n, plan.piece
    rw = (torch.ones((b, e)) if w4 is None else w4.to(g.dtype).float().reshape(b, e))
    keys = idx.reshape(b, e)
    order = torch.sort(keys, dim=1, stable=True).indices
    tex = torch.gather(keys, 1, order)
    pos = torch.arange(e).repeat(b)
    start = ((pos % length == 0)
             | torch.cat([torch.ones((b, 1), dtype=torch.bool), tex[:, 1:] != tex[:, :-1]],
                         1).reshape(-1))
    run_id = torch.cumsum(start, 0) - 1
    rows = g.float()[torch.arange(b)[:, None], order // q]
    prod = (rows if w4 is None else rw.gather(1, order)[..., None] * rows).reshape(b * e, c)
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


@pytest.mark.parametrize("b,n,k,c,dtype,hot", [
    (2, 700, 9, 6, torch.float32, 0),
    (1, 900, 5, 5, torch.bfloat16, 400),   # a row over several pieces
    (2, 3000, 257, 1, torch.float32, 0),   # the interlevel loss's one-wide rows
])
def test_row_scatter_emulation_q1_is_the_ordered_sum(b, n, k, c, dtype, hot):
    """Q = 1 with unit weights (a row gather's backward): the emulation bit
    for bit a float32 loop over each row's entries in point order, piece by
    piece, the pieces added in order; and against the plain version (each
    row's entries in point order, one after another) within 1e-6 of scale,
    bit for bit where a row's entries lie in one piece. (The kernel rounds
    the sums to g's dtype as it writes them.)"""
    rng = np.random.default_rng(11)
    idx = torch.from_numpy(rng.integers(0, k, size=(b, n, 1)))
    idx[:, :hot] = k // 2
    g = torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32)).to(dtype)
    plan = k1.bwd_plan(b, n, k, c, q=1)
    assert plan.entries == n and (hot == 0 or hot > plan.piece)
    gf, ids = g.float().numpy(), idx.numpy()
    want = np.zeros((b, k, c), np.float32)
    for bi in range(b):
        keys = ids[bi].reshape(-1)
        rowptr, ent = bucket(keys, k, plan)
        for kk in range(k):
            total, piece_sum, cur = None, None, None
            for pos in range(rowptr[kk], rowptr[kk + 1]):
                prod = gf[bi, int(ent[pos])]
                if pos // plan.piece != cur:
                    if piece_sum is not None:
                        total = piece_sum if total is None else total + piece_sum
                    piece_sum, cur = prod, pos // plan.piece
                else:
                    piece_sum = piece_sum + prod
            if piece_sum is not None:
                want[bi, kk] = piece_sum if total is None else total + piece_sum
    got = k1_emulate(g, idx, None, k, plan)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = k1.row_scatter_plain(g.float(), idx, None, k)  # its float32 sums, not rounded
    assert float((got - plain).abs().max() / plain.abs().max()) <= 1e-6


@pytest.mark.parametrize("b,n,k,c", [(7, 65536, 76800, 512), (1792, 512, 257, 1),
                                     (7, 76800, 4800, 128)])
def test_bwd_plan_sizes_q1(b, n, k, c):
    """The plan of the generalised scatter at the train step's shapes (the
    fine level's packed rows, the interlevel loss per ray, the concat
    layout's 4x upsampling as Q = 1 rows): n entries, tiles and pieces
    covering them, counters within the cap."""
    plan = k1.bwd_plan(b, n, k, c, q=1)
    assert plan.entries == n and plan.tile % 32 == 0
    assert (plan.tiles - 1) * plan.tile < n <= plan.tiles * plan.tile
    assert k * plan.tiles <= max(k1.COUNTERS, k)
    assert (plan.pieces - 1) * plan.piece < n <= plan.pieces * plan.piece
    assert plan.int_elems == b * plan.tiles * k + b * (k + 1) + b * n
    assert plan.part_elems == b * plan.pieces * 2 * c


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
    for unit weights) and the plan of q n entries, scratch of the plan's
    sizes, counted once."""
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
    plan = k1.bwd_plan(b, n, k, c, 132, q)
    assert name == "njf_row_scatter" and plan.entries == q * n
    assert args[0] == g.data_ptr() and args[5] == out.data_ptr()
    assert (args[2] != 0) == weighted
    assert out.shape == (b, k, c) and out.dtype == dtype
    iscratch, part = allocs[args[3]], allocs[args[4]]
    assert iscratch.numel() == plan.int_elems and part.numel() == plan.part_elems
    assert args[6:] == (b, k, c, n, q, plan.tile, plan.tiles, plan.piece, 1,
                        int(dtype == torch.float32), int(weighted), 0, 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_row_scatter_wrapper_passes_a_shared_table_once(fake_card, dtype):
    """idx and w [1, N, 4] for B images (the upsampling's corners): passed
    as they are, no copy per image, the shared switch on, one table's
    counters, row pointers and ids in the scratch; the output in g's
    dtype."""
    lib, allocs = fake_card
    b, n, k, c = 3, 640, 160, 16
    rng = np.random.default_rng(6)
    idx = torch.from_numpy(rng.integers(0, k, size=(1, n, 4)))
    w = torch.from_numpy(rng.uniform(size=(1, n, 4)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32)).to(dtype)
    out = k1._row_scatter_cuda(g, idx, w, k)
    ((name, args),) = lib.calls
    plan = k1.bwd_plan(b, n, k, c, 132, 4, True)
    assert name == "njf_row_scatter" and args[1] == idx.data_ptr() and args[2] == w.data_ptr()
    assert out.shape == (b, k, c) and out.dtype == dtype
    assert allocs[args[3]].numel() == plan.int_elems == plan.tiles * k + k + 1 + 4 * n
    assert args[6:] == (b, k, c, n, 4, plan.tile, plan.tiles, plan.piece, 1,
                        int(dtype == torch.float32), 1, 1, 0)


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
