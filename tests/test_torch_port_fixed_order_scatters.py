"""K1-bwd-upsample and K1-bwd-small: the orders of operations of the two
fixed-order backwards' Hopper kernels, emulated in numpy on the CPU, and the
functions they serve held against JAX.

K1-bwd-upsample (csrc/upsample_bwd.cu) gives each thread an input texel: it
finds the output rows and columns whose corners land on the texel from the
source-coordinate formula (a float guess, corrected with exact steps), and
adds their terms in output-pixel order, then corner order, with the weights
of the corner table rounded to g's dtype (below the last row and column,
one corner a pixel, without the corner tests). `upsample_emulate` repeats that
walk in float32 and is held bit for bit against the plain version (the
corner table scattered by row_scatter_plain) at 2x, 4x, 8x, a 5 -> 12
ratio and a downscale; the formula against `_upsample_corners` bit for bit,
and the texel ranges against the table's corners, at the encoder's shapes.

K1-bwd-small (csrc/small_scatter.cu) sorts one image in a block: counts per
row, an exclusive scan, a stable placing 32 entries at a time, then each
row's entries summed in entry order. `small_emulate` repeats it and is held
bit for bit against the plain version on unsorted ids with hot rows;
`small_plan`'s routing, which backward a row gather takes, and both
wrappers' launch arguments through a fake library. Then the upsampling's
backward against jax.vjp of jax.image.resize "linear", and the interlevel
loss's gradient against JAX's, in float64 (1e-12 of scale: the sums differ
in order only).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_jacobian_field_torch.ops import deterministic as det
from neural_jacobian_field_torch.ops import losses as tl
from neural_jacobian_field_torch.ops.kernels import onehot_gather as k1
from neural_jacobian_field_torch.ops.kernels import upsample_bwd as kup
from neural_jacobian_field_tpu.ops import losses as jl

F32 = np.float32


def _bf16(v: float) -> F32:
    return F32(torch.tensor(float(v)).to(torch.bfloat16).item())


# ------------------------------------------------------------ K1-bwd-upsample


def _axis(o: int, scale: F32, n_in: int):
    """The kernel's axis_at: source corners and weights of output index o."""
    src = max((F32(o) + F32(0.5)) * scale - F32(0.5), F32(0.0))
    i0 = int(src)
    w1 = src - F32(i0)
    return i0, min(i0 + 1, n_in - 1), F32(1.0) - w1, w1


def _first_at_least(t: int, scale: F32, out: int) -> int:
    """The kernel's first_at_least: the first o with a lower corner >= t."""
    if t <= 0:
        return 0
    o = max(0, min(int(np.ceil((F32(t) + F32(0.5)) / scale - F32(0.5))), out))
    while o > 0 and _axis(o - 1, scale, 1 << 30)[0] >= t:
        o -= 1
    while o < out and _axis(o, scale, 1 << 30)[0] < t:
        o += 1
    return o


def upsample_emulate(g: torch.Tensor, size) -> torch.Tensor:
    """csrc/upsample_bwd.cu's sums in its order: g [B, Ho, Wo, C] -> [B, Hi,
    Wi, C] in g's dtype."""
    b, ho, wo, c = g.shape
    hi, wi = size
    gf = g.float().numpy()
    sy, sx = F32(hi / ho), F32(wi / wo)
    rw = _bf16 if g.dtype == torch.bfloat16 else F32
    out = np.zeros((b, hi, wi, c), F32)
    for iy in range(hi):
        rows = range(_first_at_least(iy - 1, sy, ho), _first_at_least(iy + 1, sy, ho))
        for ix in range(wi):
            cols = range(_first_at_least(ix - 1, sx, wo), _first_at_least(ix + 1, sx, wo))
            interior = iy < hi - 1 and ix < wi - 1
            acc = np.zeros((b, c), F32)
            for oy in rows:
                ay = _axis(oy, sy, hi)
                for ox in cols:
                    ax = _axis(ox, sx, wi)
                    if interior:  # one corner lands on the texel: the lower where i0 is it
                        w = rw(ay[2 if ay[0] == iy else 3] * ax[2 if ax[0] == ix else 3])
                        acc = acc + w * gf[:, oy, ox]
                        continue
                    for q in range(4):
                        if (ay[q >> 1], ax[q & 1]) != (iy, ix):
                            continue
                        w = rw(ay[2 + (q >> 1)] * ax[2 + (q & 1)])
                        acc = acc + w * gf[:, oy, ox]
            out[:, iy, ix] = acc
    return torch.from_numpy(out).to(g.dtype)


@pytest.mark.parametrize("hi,wi,ho,wo,dtype", [
    (5, 6, 10, 12, torch.float32),    # 2x, the flagship's layer1
    (5, 6, 10, 12, torch.bfloat16),
    (3, 4, 12, 16, torch.float32),    # 4x, the concat layout's layer2
    (2, 3, 16, 24, torch.float32),    # 8x, its layer3
    (5, 4, 12, 11, torch.float32),    # ratios that are not integers
    (7, 9, 5, 4, torch.float32),      # a downscale: texels no output reaches
])
def test_upsample_emulation_is_the_plain_version(hi, wi, ho, wo, dtype):
    """The kernel's walk, bit for bit the plain version (the table's
    scatter in entry order), duplicate corners of the clamped last row and
    column and zero weights included; a NaN in g reaches the same texels."""
    rng = np.random.default_rng(hi * 31 + wo)
    g = torch.from_numpy(rng.normal(size=(2, ho, wo, 5)).astype(np.float32)).to(dtype)
    want = kup.upsample_bilinear_bwd_plain(g, (hi, wi))
    got = upsample_emulate(g, (hi, wi))
    assert got.dtype == want.dtype == dtype and got.shape == (2, hi, wi, 5)
    assert torch.equal(got, want)
    g[1, ho - 1, 0, 2] = float("nan")
    nan_plain = kup.upsample_bilinear_bwd_plain(g, (hi, wi)).isnan()
    assert nan_plain.any() and torch.equal(upsample_emulate(g, (hi, wi)).isnan(), nan_plain)


@pytest.mark.parametrize("n_in,n_out", [(120, 240), (160, 320), (60, 240), (80, 320),
                                        (30, 240), (40, 320), (5, 12), (7, 5), (1, 4)])
def test_upsample_formula_is_the_table(n_in, n_out):
    """The kernel's float32 source coordinate (each operation rounded, the
    scale rounded to float32) gives `_upsample_corners`'s ids and weights
    bit for bit, and each texel's range [first_at_least(t - 1),
    first_at_least(t + 1)) holds exactly the outputs with a corner on t."""
    scale = F32(n_in / n_out)
    axes = [_axis(o, scale, n_in) for o in range(n_out)]
    i0, i1 = np.array([a[0] for a in axes]), np.array([a[1] for a in axes])
    w0, w1 = np.array([a[2] for a in axes], F32), np.array([a[3] for a in axes], F32)
    ids, w = kup._upsample_corners(n_in, 1, n_out, 1, torch.float32, torch.device("cpu"))
    np.testing.assert_array_equal(ids.numpy(), np.stack([i0, i0, i1, i1], -1))
    zero = np.zeros_like(w0)  # the one-wide axis: its second corner weighs 0
    np.testing.assert_array_equal(w.numpy(), np.stack([w0, zero, w1, zero], -1))
    ids2, w2 = kup._upsample_corners(1, n_in, 1, n_out, torch.float32, torch.device("cpu"))
    np.testing.assert_array_equal(ids2.numpy(), np.stack([i0, i1, i0, i1], -1))
    np.testing.assert_array_equal(w2.numpy(), np.stack([w0, w1, zero, zero], -1))
    for t in range(n_in):
        want = np.nonzero((i0 == t) | (i1 == t))[0]
        lo, hi = _first_at_least(t - 1, scale, n_out), _first_at_least(t + 1, scale, n_out)
        np.testing.assert_array_equal(np.arange(lo, hi), want)


def test_upsample_weights_are_the_tables_products():
    """The 2D weights: the kernel's product of the two axis weights (y's
    first), float32, against the table's at 120x160 -> 240x320."""
    hi, wi, ho, wo = 120, 160, 240, 320
    sy, sx = F32(hi / ho), F32(wi / wo)
    ay, ax = [_axis(o, sy, hi) for o in range(ho)], [_axis(o, sx, wi) for o in range(wo)]
    wy = np.array([[a[2], a[3]] for a in ay], F32)
    wx = np.array([[a[2], a[3]] for a in ax], F32)
    want = np.stack([wy[:, None, 0] * wx[None, :, 0], wy[:, None, 0] * wx[None, :, 1],
                     wy[:, None, 1] * wx[None, :, 0], wy[:, None, 1] * wx[None, :, 1]], -1)
    _, w = kup._upsample_corners(hi, wi, ho, wo, torch.float32, torch.device("cpu"))
    np.testing.assert_array_equal(w.numpy(), want.reshape(ho * wo, 4))


# --------------------------------------------------------------- K1-bwd-small


def small_emulate(g: torch.Tensor, idx: torch.Tensor, k: int) -> torch.Tensor:
    """csrc/small_scatter.cu per image: counts, exclusive scan, the stable
    placing 32 entries a step (rank within the step's entries of a row),
    then each row's entries summed in list order from 0 in float32."""
    b, n, c = g.shape
    gf, ids = g.float().numpy(), idx.numpy()
    out = np.zeros((b, k, c), F32)
    for bi in range(b):
        ends = np.concatenate([[0], np.cumsum(np.bincount(ids[bi], minlength=k))[:-1]])
        lst = np.full(n, -1)
        for base in range(0, n, 32):
            step = ids[bi, base:base + 32]
            for lane, r in enumerate(step):
                lst[ends[r] + int((step[:lane] == r).sum())] = base + lane
            for r in np.unique(step):
                ends[r] += int((step == r).sum())
        assert (lst >= 0).all()
        for r in range(k):
            run = lst[(ends[r - 1] if r else 0):ends[r]]
            assert (np.diff(run) > 0).all()  # stable: the row's entries in order
            acc = np.zeros(c, F32)
            for e in run:
                acc = acc + gf[bi, e]
            out[bi, r] = acc
    return torch.from_numpy(out).to(g.dtype)


@pytest.mark.parametrize("b,n,k,c,dtype,hot", [
    (3, 700, 37, 1, torch.float32, 200),   # unsorted, a hot row across many steps
    (2, 512, 257, 1, torch.float32, 0),    # the interlevel loss's shape per ray
    (2, 300, 60, 40, torch.bfloat16, 90),  # rows wider than a warp's 32 lanes
    (1, 96, 5, 3, torch.float32, 0),       # rows no entry reaches
])
def test_small_emulation_is_the_plain_version(b, n, k, c, dtype, hot):
    rng = np.random.default_rng(n + k)
    ids = rng.integers(0, k, size=(b, n))
    if hot:
        ids[:, rng.choice(n, hot, replace=False)] = k // 3
    if k == 5:
        ids = ids % 3
    idx = torch.from_numpy(ids)
    g = torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32)).to(dtype)
    want = k1.small_scatter_plain(g, idx, k)
    got = small_emulate(g, idx, k)
    assert got.dtype == want.dtype == dtype and got.shape == (b, k, c)
    assert torch.equal(got, want)
    flipped = idx.flip(1)  # any order of ids
    assert torch.equal(small_emulate(g, flipped, k), k1.small_scatter_plain(g, flipped, k))


@pytest.mark.parametrize("n,k,c,admitted", [
    (512, 257, 1, True),        # the interlevel loss: 1,792 rays of 512 ids onto 257
    (4096, 3, 4096, True),      # a 48 KB map, the longest image
    (4096, 6144, 1, True),      # shared memory at its 48 KB
    (4096, 6145, 1, False),     # 4 bytes above it
    (4097, 10, 1, False),       # more entries than 16-bit positions walk
    (100, 12289, 1, False),     # the map above 48 KB of float32
    (65536, 76800, 512, False),  # the exact mode's fine level: K1-bwd-rows
    (324, 4800, 1, True),       # a RAFT lookup per pixel (81 points x 4 corners), 60x80
    (0, 4, 1, False),
])
def test_small_plan_admits_by_shape(n, k, c, admitted):
    smem = k1.small_plan(n, k, c)
    assert (smem is not None) == admitted
    if smem is not None:
        assert smem % 16 == 0 and 6 * n + 4 * k <= smem <= k1.SMALL_SMEM


@pytest.mark.parametrize("k,c,m,small", [(257, 1, 512, True), (100, 200, 30, False)])
def test_gather_rows_backward_takes_the_planned_scatter(monkeypatch, k, c, m, small):
    """gather_rows's backward calls K1-bwd-small where small_plan admits
    (flat's rows, g's width, the entries per image), else K1-bwd-rows; the
    gradient is the same ordered sum either way."""
    calls = []
    for name in ("small_scatter", "row_scatter"):
        real = getattr(k1, name)
        monkeypatch.setattr(k1, name, lambda *a, _n=name, _f=real: calls.append(_n) or _f(*a))
    rng = np.random.default_rng(k)
    flat = torch.from_numpy(rng.normal(size=(3, k, c)).astype(np.float32)).requires_grad_(True)
    idx = torch.from_numpy(rng.integers(0, k, size=(3, m)))
    gy = torch.from_numpy(rng.normal(size=(3, m, c)).astype(np.float32))
    (got,) = torch.autograd.grad(det.gather_rows(flat, idx), flat, gy)
    assert calls == ["small_scatter" if small else "row_scatter"]
    assert torch.equal(got, k1.row_scatter_plain(gy, idx[..., None], None, k))


def test_interlevel_loss_takes_k1_bwd_small(monkeypatch):
    """The interlevel loss's outer measure reaches K1-bwd-small, once per
    proposal level, with one image per ray."""
    shapes = []
    real = k1.small_scatter
    monkeypatch.setattr(k1, "small_scatter",
                        lambda g, idx, k: shapes.append((tuple(g.shape), k)) or real(g, idx, k))
    sdist, weights = _interlevel_inputs(np.random.default_rng(3), np.float32, levels=(16, 8, 24))
    ws = [torch.from_numpy(w).requires_grad_(True) for w in weights]
    tl.interlevel_loss([torch.from_numpy(s) for s in sdist], ws).backward()
    assert sorted(shapes) == [((6, 48, 1), 9), ((6, 48, 1), 17)]


# ---------------------------------------------------------------- the wrappers


class _FakeLib:
    def __init__(self):
        self.calls = []

    def call(self, name, *args):
        self.calls.append((name, args))


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' host side on CPU tensors: no device checks, no stream, a
    fake library that records its calls."""
    lib = _FakeLib()
    for mod in (k1, kup):
        monkeypatch.setattr(mod, "load_kernels", lambda: lib)
        monkeypatch.setattr(mod, "check_cuda_tensor", lambda *a, **kw: None)
        monkeypatch.setattr(mod, "stream_of", lambda t: 0)
        monkeypatch.setattr(mod, "_on_device", lambda t: contextlib.nullcontext())
    return lib


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_upsample_wrapper_launches_once(fake_card, dtype):
    """One call of njf_upsample_bwd with g as it is, the sizes and the type
    switch, the output [B, Hi, Wi, C] in g's dtype, counted once."""
    g = torch.zeros((3, 10, 14, 64), dtype=dtype)
    n0 = kup.upsample_bilinear_bwd.launches
    out = kup._upsample_bilinear_bwd_cuda(g, (5, 7))
    assert kup.upsample_bilinear_bwd.launches == n0 + 1
    ((name, args),) = fake_card.calls
    assert name == "njf_upsample_bwd" and out.shape == (3, 5, 7, 64) and out.dtype == dtype
    assert args == (g.data_ptr(), out.data_ptr(), 3, 5, 7, 10, 14, 64,
                    int(dtype == torch.float32), 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_small_wrapper_launches_by_the_plan(fake_card, dtype):
    """One call of njf_small_scatter with the ids as they are (int64, no
    copy), the plan's shared memory and the type switch, counted once; a
    shape small_plan refuses raises, and launches nothing."""
    b, n, k, c = 4, 512, 257, 1
    g = torch.zeros((b, n, c), dtype=dtype)
    idx = torch.zeros((b, n), dtype=torch.int64)
    n0 = k1.small_scatter.launches
    out = k1._small_scatter_cuda(g, idx, k)
    assert k1.small_scatter.launches == n0 + 1
    ((name, args),) = fake_card.calls
    assert name == "njf_small_scatter" and out.shape == (b, k, c) and out.dtype == dtype
    assert args == (g.data_ptr(), idx.data_ptr(), out.data_ptr(), b, k, c, n,
                    k1.small_plan(n, k, c), int(dtype == torch.float32), 0)
    with pytest.raises(ValueError, match="small_plan"):
        k1._small_scatter_cuda(torch.zeros((1, 5000, 1), dtype=dtype),
                               torch.zeros((1, 5000), dtype=torch.int64), k)
    assert k1.small_scatter.launches == n0 + 1 and len(fake_card.calls) == 1


# ------------------------------------------------------------- against JAX


@pytest.mark.parametrize("hi,wi,ho,wo", [(3, 4, 6, 8), (2, 3, 16, 24), (5, 4, 12, 11)])
def test_upsample_backward_against_jax(hi, wi, ho, wo):
    """upsample_bilinear's gradient (K1-bwd-upsample's plain version) against
    jax.vjp of jax.image.resize "linear", float64, within 1e-12 of scale:
    2x, 8x and a ratio that is not an integer."""
    rng = np.random.default_rng(hi + 10 * wo)
    x = rng.normal(size=(2, hi, wi, 3))
    gy = rng.normal(size=(2, ho, wo, 3))
    with jax.enable_x64(True):
        _, vjp = jax.vjp(lambda t: jax.image.resize(t, (2, ho, wo, 3), method="linear"),
                         jnp.asarray(x))
        want = np.asarray(vjp(jnp.asarray(gy))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad(det.upsample_bilinear(xt, (ho, wo)), xt, torch.from_numpy(gy))
    assert got.dtype == torch.float64
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()


def _interlevel_inputs(rng, dtype, rays=6, levels=(16, 8, 48)):
    """Edges in [0, 1] (sorted, the ends included) and weights per level."""
    sdist, weights = [], []
    for s in levels:
        inner = np.sort(rng.uniform(size=(rays, s - 1)), axis=-1)
        sdist.append(np.concatenate([np.zeros((rays, 1)), inner, np.ones((rays, 1))],
                                    -1).astype(dtype))
        weights.append(rng.uniform(0.0, 0.2, size=(rays, s, 1)).astype(dtype))
    return sdist, weights


def test_interlevel_loss_gradient_against_jax():
    """interlevel_loss and its gradient with respect to each proposal
    level's weights (through K1-bwd-small's plain version) against JAX's,
    float64: the loss and the gradients within 1e-12 of their scale."""
    sdist, weights = _interlevel_inputs(np.random.default_rng(8), np.float64)
    with jax.enable_x64(True):
        loss_j, grads_j = jax.value_and_grad(
            lambda ws: jl.interlevel_loss([jnp.asarray(s) for s in sdist], ws))(
            [jnp.asarray(w) for w in weights])
    ws = [torch.from_numpy(w).requires_grad_(True) for w in weights]
    loss = tl.interlevel_loss([torch.from_numpy(s) for s in sdist], ws)
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - float(loss_j)) <= 1e-12 * abs(float(loss_j))
    for w, gj in zip(ws[:-1], grads_j[:-1]):
        gj = np.asarray(gj)
        assert np.abs(gj).max() > 0
        assert np.abs(w.grad.numpy() - gj).max() <= 1e-12 * np.abs(gj).max()
    assert ws[-1].grad is None  # the final level is detached, as in JAX
