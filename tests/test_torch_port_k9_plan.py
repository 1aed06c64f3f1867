"""The K9 kernels' launch plans, on the CPU.

`conv_plan` and `wgrad_plan` choose each stride-1 conv's tiles, grid and
pixel slices for the TMA kernels (csrc/conv3x3_s1.cu, csrc/conv3x3_wgrad.cu);
the kernels take the plan as arguments. Here the plans are held at the
encoder's shapes (B = 1 and batch 7) and the test shapes: every output pixel
and channel in exactly one tile, the K steps and the wgrad slices covering
their ranges once and in order, K9-fwd and K10 on one plan, the legacy
kernel exactly where C or Cout is not a multiple of 8. A float32 emulation
of the planned tiles, K order and ordered slice sums in plain torch then
equals the plain versions (themselves held against the JAX package in
test_torch_port_kernels.py and test_torch_port_k10.py).
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neural_jacobian_field_torch.ops.kernels import conv_suite as cs

# (b, h, w, c, cout): the encoder's stride-1 convs at 480x640 (layer1-3) at
# B = 1 and batch 7, and the shapes the card tests use
ENCODER = [(b, h, w, c, c) for b in (1, 7) for h, w, c in
           ((120, 160, 64), (60, 80, 128), (30, 40, 256))]
TEST_SHAPES = [(1, 7, 9, 12, 20), (2, 5, 33, 64, 72), (2, 30, 40, 72, 72),
               (1, 17, 33, 8, 80), (3, 9, 11, 136, 24), (2, 6, 10, 64, 20)]
SHAPES = ENCODER + TEST_SHAPES


def _tile_pixels(plan, b, h, w):
    """How often each output pixel is stored by the plan's row blocks."""
    hits = np.zeros((b, h, w), dtype=np.int64)
    if plan.legacy:
        flat = hits.reshape(-1)
        for m in range(plan.m_tiles):
            flat[m * 64:(m + 1) * 64] += 1
        return hits
    for t in range(plan.m_tiles):
        tx, ty, bb = t % plan.tiles_x, (t // plan.tiles_x) % plan.tiles_y, \
            t // (plan.tiles_x * plan.tiles_y)
        y0, x0 = ty * plan.th, tx * plan.tw
        for r in range(plan.th * plan.tw):  # the kernel's row -> pixel map
            py, px = y0 + r // plan.tw, x0 + r % plan.tw
            if py < h and px < w:
                hits[bb, py, px] += 1
    return hits


def _ranges_partition(ranges, n):
    """[begin, end) ranges, in order, that cover [0, n) once, none empty."""
    return (ranges[0][0] == 0 and ranges[-1][1] == n
            and all(a < e for a, e in ranges)
            and all(e == a2 for (_, e), (a2, _) in zip(ranges, ranges[1:])))


@pytest.mark.parametrize("b,h,w,c,cout", SHAPES)
def test_conv_plan_covers_every_pixel_and_channel_once(b, h, w, c, cout):
    plan = cs.conv_plan(b, h, w, c, cout)
    assert plan.legacy == bool(c % 8 or cout % 8)
    assert (_tile_pixels(plan, b, h, w) == 1).all()
    assert _ranges_partition([(n * 64, min(cout, (n + 1) * 64)) for n in range(plan.n_tiles)],
                             cout)
    if not plan.legacy:
        assert plan.th * plan.tw in (64, 128) and plan.tw in (8, 16)
        assert plan.bn == 64 and plan.m_tiles == b * plan.tiles_y * plan.tiles_x


@pytest.mark.parametrize("c", [8, 12, 64, 72, 128, 256])
def test_k_steps_cover_the_contraction_once(c):
    steps = cs.k_steps(c)
    cols = [tap * c + ch for tap, c0 in steps for ch in range(c0, min(c, c0 + 64))]
    assert sorted(cols) == list(range(9 * c))  # each column of the [9C] contraction once
    assert len(steps) == 9 * -(-c // 64)
    # a chunk's three tap columns in a row, the three taps of a column together
    assert [t % 3 for t, _ in steps[:9]] == [0, 0, 0, 1, 1, 1, 2, 2, 2]


@pytest.mark.parametrize("b,h,w,c,cout", SHAPES)
def test_wgrad_plan_slices_cover_their_range_once_in_order(b, h, w, c, cout):
    plan = cs.wgrad_plan(b, h, w, c, cout)
    assert plan.legacy == bool(c % 8 or cout % 8)
    if plan.legacy:
        assert plan.per % 32 == 0 and plan.splits * plan.per >= b * h * w
        assert (plan.splits - 1) * plan.per < b * h * w
        return
    assert plan.th * plan.tw == 64 and plan.tw in (8, 16, 32)
    assert plan.p_tiles == b * plan.tiles_y * plan.tiles_x
    assert _ranges_partition(plan.slices(), plan.p_tiles)
    # the grid stays within one wave of the card's 132 SMs where it can
    blocks = plan.k_tiles * plan.n_tiles * plan.splits
    assert blocks <= max(cs.SMS, plan.k_tiles * plan.n_tiles)
    # every dW row and column in one tile: 3 tap columns x the 64-channel chunks
    assert plan.k_tiles == 3 * -(-c // 64)
    assert plan.n_tiles * 64 * plan.nh >= cout > (plan.n_tiles - 1) * 64 * plan.nh


@pytest.mark.parametrize("b,h,w,c,cout", ENCODER)
def test_encoder_shapes_take_the_tma_path_with_enough_blocks(b, h, w, c, cout):
    """No main-path shape reaches the legacy kernels; the training-size
    wgrad grid fills most of the card."""
    plan, wplan = cs.conv_plan(b, h, w, c, cout), cs.wgrad_plan(b, h, w, c, cout)
    assert not plan.legacy and not wplan.legacy
    assert plan.m_tiles * plan.n_tiles >= 75
    if b == 7:
        assert wplan.k_tiles * wplan.n_tiles * wplan.splits >= 100


class _FakeLib:
    """Stands in for the kernel library: records each call's arguments."""

    def __init__(self):
        self.calls = []

    def call(self, name, *args):
        self.calls.append((name, args))


@pytest.fixture
def fake_card(monkeypatch):
    """Run the CUDA wrappers' host side on CPU tensors: no checks of the
    device, no stream, a fake library, a 132-SM card."""
    lib = _FakeLib()
    monkeypatch.setattr(cs, "load_kernels", lambda: lib)
    monkeypatch.setattr(cs, "check_cuda_tensor", lambda *a, **k: None)
    monkeypatch.setattr(cs, "stream_of", lambda t: 0)
    monkeypatch.setattr(cs, "_sms", lambda index: cs.SMS)
    monkeypatch.setattr(cs, "_on_device", lambda t: contextlib.nullcontext())
    return lib


@pytest.mark.parametrize("b,h,w,c,cout", SHAPES)
def test_fwd_and_k10_launch_one_plan(fake_card, b, h, w, c, cout):
    """K9-fwd and K10 hand the kernel the same plan for the same shape (so
    K10's y is K9-fwd's bit for bit), K10 sizes its partial rows by it, the
    dgrad plans with the channels swapped, and the legacy counters move
    exactly for the legacy plans."""
    x = torch.zeros((b, h, w, c), dtype=torch.bfloat16)
    wt = torch.zeros((3, 3, c, cout), dtype=torch.bfloat16)
    gy = torch.zeros((b, h, w, cout), dtype=torch.bfloat16)
    plan = cs.conv_plan(b, h, w, c, cout)
    counters = [cs.conv3x3_s1, cs.conv3x3_s1_stats, cs.conv3x3_s1_dgrad, cs.conv3x3_s1_wgrad]
    before = [(f.launches, f.legacy_launches) for f in counters]
    cs._conv3x3_s1_cuda(x, wt, cs.conv3x3_s1)
    cs._conv3x3_s1_stats_cuda(x, wt)
    cs._conv3x3_s1_cuda(gy, wt, cs.conv3x3_s1_dgrad, dgrad=True)
    cs._conv3x3_s1_wgrad_cuda(x, gy)
    (fwd, fa), (stats, sa), (dgrad, da), (wgrad, wa) = fake_card.calls
    assert (fwd, stats, dgrad, wgrad) == ("njf_conv3x3_s1_fwd", "njf_conv3x3_s1_fwd_stats",
                                          "njf_conv3x3_s1_fwd", "njf_conv3x3_s1_wgrad")
    assert fa[3:11] == (b, h, w, c, cout, plan.th, plan.tw, plan.bn) and fa[11] == 0
    assert sa[6:15] == (b, h, w, c, cout, plan.th, plan.tw, plan.bn, plan.m_tiles)
    dplan = cs.conv_plan(b, h, w, cout, c)
    assert da[3:12] == (b, h, w, cout, c, dplan.th, dplan.tw, dplan.bn, 1)
    wp = cs.wgrad_plan(b, h, w, c, cout)
    assert wa[4:14] == (b, h, w, c, cout, wp.th, wp.tw, wp.nh, wp.splits, wp.per)
    legacy = [plan.legacy, plan.legacy, dplan.legacy, wp.legacy]
    assert [(f.launches - n, f.legacy_launches - m) for f, (n, m) in zip(counters, before)] \
        == [(1, int(lg)) for lg in legacy]


# ------------------------------------------- float32 emulation of the plans

def _box(xp, bb, y0, x0, th, tw, c0):
    """A TMA box (64 channels, tw, th, 1) of the zero-padded image xp
    [B, H + 2, W + 2 + pad, C + 64] at image coordinates (y0, x0); what
    lies outside the image reads zero. Rows in the kernel's order."""
    return xp[bb, y0 + 1:y0 + 1 + th, x0 + 1:x0 + 1 + tw, c0:c0 + 64].reshape(th * tw, 64)


def _pad(x, th, tw):
    """x with a one-pixel zero halo, zeros past the bottom / right edge for
    hanging patches, and 64 zero channels past C."""
    h, w = x.shape[1:3]
    return F.pad(x, (0, 64, 1, tw + 1, 1, th + 1))[:, :h + th + 2, :w + tw + 2]


def emulate_conv(x, w, plan):
    """The TMA forward kernel's arithmetic in float32: per row block and
    channel tile, the K steps in `k_steps` order, each a [th*tw, 64] x [64,
    bn] product added into the accumulator; rows inside the image stored.
    Also K10's sums: per block over its valid rows, then over the blocks in
    order."""
    b, h, wd, c = x.shape
    cout = w.shape[-1]
    th, tw, bn = plan.th, plan.tw, plan.bn
    xp = _pad(x, th, tw)
    wp = F.pad(w.reshape(9, c, cout), (0, bn, 0, 64))  # zero past C and Cout
    y = torch.zeros((b, h, wd, cout))
    part1 = torch.zeros((plan.m_tiles, cout))
    part2 = torch.zeros((plan.m_tiles, cout))
    r = torch.arange(th * tw)
    for t in range(plan.m_tiles):
        tx, ty, bb = t % plan.tiles_x, (t // plan.tiles_x) % plan.tiles_y, \
            t // (plan.tiles_x * plan.tiles_y)
        y0, x0 = ty * th, tx * tw
        py, px = y0 + r // tw, x0 + r % tw
        ok = (py < h) & (px < wd)
        for n in range(plan.n_tiles):
            n0 = n * bn
            acc = torch.zeros((th * tw, bn))
            for tap, c0 in cs.k_steps(c):
                dy, dx = divmod(tap, 3)
                acc += _box(xp, bb, y0 + dy - 1, x0 + dx - 1, th, tw, c0) \
                    @ wp[tap, c0:c0 + 64, n0:n0 + bn]
            cols = slice(n0, min(cout, n0 + bn))
            acc = acc[:, :cols.stop - n0]
            y[bb, py[ok], px[ok], cols] = acc[ok]
            part1[t, cols] = acc[ok].sum(0)
            part2[t, cols] = (acc[ok] ** 2).sum(0)
    s1, s2 = torch.zeros(cout), torch.zeros(cout)
    for t in range(plan.m_tiles):  # the ordered sum over the blocks
        s1 += part1[t]
        s2 += part2[t]
    return y, s1, s2


def emulate_wgrad(x, g, plan):
    """The TMA wgrad kernel's arithmetic in float32: per slice of patches, in
    order, each tap's shifted x box transposed times the patch's g box (zero
    outside the image), into the slice's partial; the partials added in
    slice order."""
    b, h, wd, c = x.shape
    cout = g.shape[-1]
    th, tw = plan.th, plan.tw
    xp = _pad(x, th, tw)
    gp = _pad(g, th, tw)
    partials = []
    for lo, hi in plan.slices():
        part = torch.zeros((9, c + 64, cout + 64))
        for t in range(lo, hi):
            tx, ty, bb = t % plan.tiles_x, (t // plan.tiles_x) % plan.tiles_y, \
                t // (plan.tiles_x * plan.tiles_y)
            y0, x0 = ty * th, tx * tw
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                for c0 in range(0, c, 64):
                    xa = _box(xp, bb, y0 + dy - 1, x0 + dx - 1, th, tw, c0)
                    for n0 in range(0, cout, 64):
                        part[tap, c0:c0 + 64, n0:n0 + 64] += xa.t() @ _box(gp, bb, y0, x0, th,
                                                                          tw, n0)
        partials.append(part[:, :c, :cout])
    dw = torch.zeros((9, c, cout))
    for part in partials:
        dw += part
    return dw.reshape(3, 3, c, cout)


def _inputs(b, h, w, c, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32))
    wt = torch.from_numpy((rng.standard_normal((3, 3, c, cout)) / np.sqrt(9 * c))
                          .astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((b, h, w, cout)).astype(np.float32))
    return x, wt, g


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


# (b, h, w, c, cout, patch): natural plans and forced ones that hang over
# the bottom and right edges
EMULATED = [(2, 5, 33, 64, 72, None), (2, 12, 20, 72, 136, (8, 16)),
            (1, 9, 13, 16, 64, (16, 8)), (1, 30, 40, 8, 8, None), (1, 30, 20, 16, 72, (8, 8))]


@pytest.mark.parametrize("b,h,w,c,cout,patch", EMULATED)
def test_planned_forward_and_stats_equal_the_plain_versions(b, h, w, c, cout, patch):
    """float32 throughout: the planned tiles and K order reorder float32
    sums only, 1e-5 of scale; the dgrad the same on the rotated weights."""
    x, wt, g = _inputs(b, h, w, c, cout)
    plan = cs.conv_plan(b, h, w, c, cout, patch=patch)
    y, s1, s2 = emulate_conv(x, wt, plan)
    py, p1, p2 = cs.conv3x3_s1_stats_plain(x, wt)
    assert _rel(y, py) <= 1e-5
    assert _rel(s1, p1) <= 1e-5 and _rel(s2, p2) <= 1e-5
    dplan = cs.conv_plan(b, h, w, cout, c, patch=patch)
    dx, _, _ = emulate_conv(g, cs._rotate(wt), dplan)
    assert _rel(dx, cs.conv3x3_s1_dgrad_plain(g, wt)) <= 1e-5


@pytest.mark.parametrize("b,h,w,c,cout,patch", [
    (2, 5, 33, 64, 72, None), (2, 12, 20, 72, 136, (2, 32)), (1, 30, 40, 8, 16, None)])
def test_planned_wgrad_slices_equal_the_plain_version(b, h, w, c, cout, patch):
    """The slices' float32 partials, added in slice order: 1e-5 of scale."""
    x, _, g = _inputs(b, h, w, c, cout, seed=1)
    plan = cs.wgrad_plan(b, h, w, c, cout, sms=64, patch=patch)
    assert plan.splits > 1
    assert _rel(emulate_wgrad(x, g, plan), cs.conv3x3_s1_wgrad_plain(x, g)) <= 1e-5
