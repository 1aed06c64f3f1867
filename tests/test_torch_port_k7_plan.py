"""The K7 forward kernels' launch plan and forward-only packing, on the CPU.

`field_mlp.fwd_plan` chooses, per trunk shape, between the persistent wgmma
kernel (csrc/field_mlp.cu: tiles of 128 points, two consumer warpgroups, a
ring of TMA-fed stages) and the legacy WMMA kernel; the kernel takes the
plan's grid and shared memory as arguments. Here the plan is held at the
flagship's shapes (a serving chunk of 2,048 rays x 256 samples, a batch-7
train step's 7 x 256 x 256 points, a ragged 4,099) and at the card tests'
shapes: every point in exactly one tile, the shared memory within the
H100's 232,448 bytes, every ring step's loads within a stage, the legacy
kernel exactly where the plan says. `_pack_fwd`'s weights and biases unpack
back to the parameters, x_pe's padding keeps the values, and the wrappers
hand the fake library what the plan says. Pure Python and torch: no JAX.
"""

import contextlib
import math

import pytest
import torch

from neural_jacobian_field_torch.models.resnet_fc import MlpCfg
from neural_jacobian_field_torch.ops.kernels import field_mlp as fm

FLAGSHIP = (128, 128, 256)  # the latent levels' widths
# (n, d_in, dh, n_blocks, n_lin_z, d_out, widths or None for tz mode)
SHAPES = ([(n, 63, 128, 5, 3, d_out, w) for n in (524288, 458752, 4099) for d_out in (1, 16, 24)
           for w in (None, FLAGSHIP)]
          + [(4099, 63, 128, 0, 0, 16, None), (65537, 63, 128, 5, 3, 16, None),
             (50, 63, 128, 5, 3, 24, FLAGSHIP), (4099, 63, 128, 5, 0, 16, FLAGSHIP),
             (4099, 63, 128, 5, 3, 16, (512,)), (700, 63, 32, 2, 2, 16, None),
             (333, 63, 64, 3, 1, 24, (16, 32, 48)), (1000, 63, 64, 2, 0, 8, (32, 32)),
             (1000, 63, 128, 3, 3, 16, (16, 32, 48))])


def _ids(shape):
    n, _, dh, nb, nlz, d_out, w = shape
    return f"n{n}-dh{dh}-b{nb}-z{nlz}-o{d_out}-" + ("tz" if w is None else "x".join(map(str, w)))


def _steps(plan, n_blocks, n_lin_z, widths, f32_levels=()):
    """The ring steps of one tile as the kernel's producer issues them:
    (weight rows loaded: (first row, rows, column halves), bytes). Weight
    boxes are 64 rows x 128 bytes; each consumer adds its input boxes."""
    box, c = 64 * 128, plan.consumers
    rows = {name: (r0, k) for name, r0, k in fm.fwd_weight_rows(
        n_blocks, n_lin_z, sum(widths) if widths else 0)}
    steps = [((0, fm.FWD_K_IN, 2), 2 * box + c * box)]  # W_in + x_pe
    for blk in range(n_blocks):
        if widths is not None and blk < n_lin_z:
            r0, off = rows[f"lin_z_{blk}"][0], 0
            for lvl, w in enumerate(widths):
                for c0 in range(0, w, 64):
                    boxes = 2 if lvl in f32_levels else 1
                    steps.append(((r0 + off + c0, 64, 2), 2 * box + c * boxes * box))
                off += w
        tz = widths is None and blk < n_lin_z
        steps.append(((rows[f"blocks_{blk}_fc_0"][0], 128, 2), 4 * box + (2 * c * box if tz else 0)))
        steps.append(((rows[f"blocks_{blk}_fc_1"][0], 128, 2), 4 * box))
    steps.append(((rows["lin_out"][0], 128, 1), 2 * box))
    return steps


def _plan(shape):
    n, d_in, dh, nb, nlz, d_out, w = shape
    return fm.fwd_plan(n, d_in, dh, nb, nlz, d_out, w)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_tiles_cover_every_point_once(shape):
    """The persistent blocks' tiles (block b: b, b + grid, ...) cover
    [0, n_tiles) exactly once, and the tiles cover the n points with less
    than one tile to spare; the wgmma kernel keeps one block per SM."""
    plan = _plan(shape)
    hits = [0] * plan.n_tiles
    for b in range(plan.grid):
        for t in plan.tiles(b):
            hits[t] += 1
    assert hits == [1] * plan.n_tiles
    n = shape[0]
    assert plan.n_tiles * plan.tile >= n > (plan.n_tiles - 1) * plan.tile
    if not plan.legacy:
        assert plan.grid == min(plan.n_tiles, 132) and plan.tile == 128


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_shared_memory_and_stage_bytes(shape):
    """The ring, the biases and the barriers fit in a block's shared memory;
    a stage holds a [128, 128] bf16 weight matrix and each consumer's 64
    points x 128 bf16 of input; every step of a tile loads at most one
    stage (the float32 latent level takes two boxes a step); the weight
    steps read each packed row once per tile."""
    n, d_in, dh, nb, nlz, d_out, w = shape
    plan = _plan(shape)
    if plan.legacy:
        return
    assert plan.smem <= 232448
    assert plan.stage_bytes == 128 * 128 * 2 + plan.consumers * 64 * 128 * 2
    assert plan.smem == (1024 + plan.stages * plan.stage_bytes
                         + 4 * fm.fwd_bias_floats(nb, nlz) + 16 * plan.stages)
    f32 = (len(w) - 1,) if w and len(w) > 1 else ()
    steps = _steps(plan, nb, nlz, w, f32)
    assert max(b for _, b in steps) <= plan.stage_bytes
    read = sorted((r0, k) for (r0, k, _), _ in steps)
    layout = fm.fwd_weight_rows(nb, nlz, sum(w) if w else 0)
    total = layout[-1][1] + layout[-1][2]
    assert sum(k for _, k in read) == total
    assert all(a[0] + a[1] == b[0] for a, b in zip(read, read[1:]))


@pytest.mark.parametrize("dh,d_in,d_out,widths,n_blocks,legacy", [
    (128, 63, 24, None, 5, False),
    (128, 63, 24, FLAGSHIP, 5, False),
    (128, 64, 64, (64,), 5, False),
    (64, 63, 16, None, 5, True),
    (32, 63, 16, None, 5, True),
    (128, 63, 16, (16, 32, 48), 5, True),       # levels not multiples of 64
    (128, 63, 16, (128, 128, 256, 64), 5, True),  # four levels
    (128, 65, 16, None, 5, True),               # d_in past the 64-row W_in
    (128, 63, 16, None, 40, True),              # biases past the shared memory
])
def test_legacy_exactly_where_the_plan_says(dh, d_in, d_out, widths, n_blocks, legacy):
    plan = fm.fwd_plan(4099, d_in, dh, n_blocks, min(3, n_blocks), d_out, widths)
    assert plan.legacy == legacy
    assert (plan.tile, plan.grid) == ((64, plan.n_tiles) if legacy else (128, 33))


def _params(g, d_in, dh, n_blocks, n_lin_z, d_out, d_lat):
    def lin(din, dout):
        return {"kernel": torch.randn((din, dout), generator=g) / math.sqrt(din),
                "bias": 0.1 * torch.randn((dout,), generator=g)}

    p = {"lin_in": lin(d_in, dh), "lin_out": lin(dh, d_out)}
    for i in range(n_lin_z):
        p[f"lin_z_{i}"] = lin(d_lat, dh) if d_lat else {"bias": lin(1, dh)["bias"]}
    for i in range(n_blocks):
        p[f"blocks_{i}_fc_0"] = lin(dh, dh)
        p[f"blocks_{i}_fc_1"] = lin(dh, dh)
    return p


@pytest.mark.parametrize("n_blocks,n_lin_z,d_out,d_lat", [
    (5, 3, 1, 0), (5, 3, 24, 512), (2, 0, 16, 0), (0, 0, 16, 512)])
def test_pack_fwd_unpacks_to_the_params(n_blocks, n_lin_z, d_out, d_lat):
    """`_pack_fwd`'s weight rows (`fwd_weight_rows`) hold each kernel rounded
    to bf16, zeros past d_in and d_out; its biases hold b_in, b_z, per block
    b0 and b1, and b_out padded to 64, as bf16 values."""
    params = _params(torch.Generator().manual_seed(0), 63, 128, n_blocks, n_lin_z, d_out, d_lat)
    cfg = MlpCfg(n_blocks=n_blocks, d_hidden=128, combine_layer=n_lin_z)
    w, b = fm._pack_fwd(params, cfg, 63, d_out, "cpu", projection=d_lat > 0)
    assert w.dtype == torch.bfloat16 and b.dtype == torch.float32 and w.shape[1] == 128
    layout = fm.fwd_weight_rows(n_blocks, n_lin_z, d_lat)
    assert w.shape[0] == layout[-1][1] + layout[-1][2]
    for layer, r0, k in layout:
        want = params[layer]["kernel"].to(torch.bfloat16)
        got = w[r0:r0 + k]
        assert torch.equal(got[:want.shape[0], :want.shape[1]], want), layer
        assert not got[want.shape[0]:].any() and not got[:, want.shape[1]:].any(), layer
    assert b.numel() == fm.fwd_bias_floats(n_blocks, n_lin_z)
    names = (["lin_in"] + [f"lin_z_{i}" for i in range(n_lin_z)]
             + [f"blocks_{i}_fc_{j}" for i in range(n_blocks) for j in (0, 1)])
    for i, name in enumerate(names):
        assert torch.equal(b[128 * i:128 * (i + 1)],
                           params[name]["bias"].to(torch.bfloat16).float()), name
    tail = b[128 * len(names):]
    assert torch.equal(tail[:d_out], params["lin_out"]["bias"].to(torch.bfloat16).float())
    assert tail.numel() == 64 and not tail[d_out:].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pad_x_keeps_values_and_zeroes_the_pad(dtype):
    x = torch.randn((3, 5, 63), generator=torch.Generator().manual_seed(1)).to(dtype)
    xp = fm._pad_x(x, 63)
    assert xp.shape == (15, 64) and xp.dtype == torch.bfloat16 and xp.is_contiguous()
    assert torch.equal(xp[:, :63], x.reshape(15, 63).to(torch.bfloat16))
    assert not xp[:, 63].any()


class _FakeLib:
    def __init__(self):
        self.calls = []

    def call(self, name, *args):
        self.calls.append((name, args))


@pytest.fixture
def fake_card(monkeypatch):
    """The forward wrappers' host side on CPU tensors: no device checks, no
    stream, a fake library, a 132-SM card."""
    lib = _FakeLib()
    monkeypatch.setattr(fm, "load_kernels", lambda: lib)
    monkeypatch.setattr(fm, "check_cuda_tensor", lambda *a, **k: None)
    monkeypatch.setattr(fm, "stream_of", lambda t: 0)
    monkeypatch.setattr(fm, "_sms", lambda index: 132)
    monkeypatch.setattr(fm, "_on_device", lambda t: contextlib.nullcontext())
    return lib


@pytest.mark.parametrize("proj,dh,widths", [
    (False, 128, None), (True, 128, FLAGSHIP), (False, 64, None), (True, 128, (16, 32, 48))])
def test_wrappers_launch_by_the_plan(fake_card, proj, dh, widths):
    """Each forward wrapper calls the wgmma entry point with the plan's grid
    and shared memory, or the legacy one, and counts the launch (and a
    legacy launch) on itself."""
    n, d_out = 4099, 24
    g = torch.Generator().manual_seed(2)
    d_lat = sum(widths) if proj else 0
    params = _params(g, 63, dh, 5, 3, d_out, d_lat)
    cfg = MlpCfg(n_blocks=5, d_hidden=dh, combine_layer=3)
    x = torch.rand((n, 63), generator=g).to(torch.bfloat16)
    if proj:
        lat = tuple(torch.randn((n, c), generator=g).to(torch.float32 if i == len(widths) - 1
                                                          else torch.bfloat16)
                    for i, c in enumerate(widths))
        wrapper, fn = fm.fused_resnet_fc, fm._fused_resnet_fc_cuda
    else:
        lat = torch.randn((n, 3 * dh), generator=g).to(torch.bfloat16)
        wrapper, fn = fm.fused_resnet_fc_tz, fm._fused_resnet_fc_tz_cuda
    plan = fm.fwd_plan(n, 63, dh, 5, 3, d_out, widths)
    n0, l0 = wrapper.launches, wrapper.legacy_launches
    out = fn(params, cfg, lat, x, d_out)
    assert out.shape == (n, d_out)
    ((name, args),) = fake_card.calls
    assert (wrapper.launches - n0, wrapper.legacy_launches - l0) == (1, int(plan.legacy))
    base = "njf_field_mlp_fwd" if proj else "njf_field_mlp_tz_fwd"
    assert name == (base if plan.legacy else base + "_wg")
    if not plan.legacy:
        assert args[-3:] == (plan.grid, plan.smem, 0)
        assert args[-7:-3] == (n, 5, 3, d_out)
