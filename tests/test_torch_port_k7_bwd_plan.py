"""The K7 backward kernels' launch plan and decomposition, on the CPU.

`field_mlp.bwd_plan` chooses, per trunk shape, between the two wgmma passes
(csrc/field_mlp_bwd.cu: a persistent gradient chain over tiles of 128 points
that writes the weight gradients' bf16 operands to a scratch, then one
split-K kernel over points for every layer's dW = A^T G, in chunks of
points) and the legacy WMMA kernel. Here: every point in exactly one chunk,
tile and split, in order; the chain's shared memory within the H100's
232,448 bytes; the scratch within its cap; the legacy kernel exactly where
the plan says; the job table's operands and output layout; the wrappers'
arguments through a fake library; and the decomposition itself written in
torch (the chain's operands, the chunked split-K A^T G, the ordered sums,
the unpacking) against the plain versions, to float32 summation order.
Pure Python and torch: no JAX.
"""

import contextlib
import math

import pytest
import torch
import torch.nn.functional as F

from neural_jacobian_field_torch.models.resnet_fc import MlpCfg
from neural_jacobian_field_torch.ops.kernels import field_mlp as fm

FLAGSHIP = (128, 128, 256)  # the latent levels' widths
# (n, d_out, n_blocks, n_lin_z, widths or None for tz mode)
SHAPES = ([(n, d_out, 5, 3, w) for n in (458752, 2640896, 4099) for d_out in (1, 16, 24)
           for w in (None, FLAGSHIP)]
          + [(50, 24, 5, 3, None), (65537, 16, 5, 3, FLAGSHIP), (4099, 16, 0, 0, None),
             (4099, 16, 5, 0, FLAGSHIP), (4099, 16, 5, 1, None), (4099, 16, 5, 3, (512,)),
             (300000, 24, 6, 6, FLAGSHIP)])


def _ids(shape):
    n, d_out, nb, nlz, w = shape
    return f"n{n}-o{d_out}-b{nb}-z{nlz}-" + ("tz" if w is None else "x".join(map(str, w)))


def _plan(shape, **kw):
    n, d_out, nb, nlz, w = shape
    return fm.bwd_plan(n, 63, 128, nb, nlz, d_out, w, **kw)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_chunks_tiles_and_splits_cover_every_point_once(shape):
    """The chunks tile [0, n) in order; in each, the chain's persistent
    blocks (block b: tiles b, b + grid, ...) cover its 128-point tiles once
    and the splits cover its 64-point tiles once, in order, none empty."""
    n = shape[0]
    plan = _plan(shape)
    assert not plan.legacy
    chunks = plan.chunks(n)
    assert chunks[0][0] == 0 and sum(c[1] for c in chunks) == n
    assert all(a[0] + a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(c[1] == plan.chunk for c in chunks[:-1]) and 0 < chunks[-1][1] <= plan.chunk
    for _, nc, grid, splits, per in chunks:
        tiles = -(-nc // plan.tile)
        assert grid == min(plan.grid, tiles) <= 132
        hits = [0] * tiles
        for b in range(grid):
            for t in range(b, tiles, grid):
                hits[t] += 1
        assert hits == [1] * tiles
        tiles64 = -(-nc // 64)
        ranges = [range(s * per, min(tiles64, (s + 1) * per)) for s in range(splits)]
        assert [t for r in ranges for t in r] == list(range(tiles64))
        assert all(len(r) > 0 for r in ranges)
    assert len(plan.jobs) * plan.splits <= 132


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_shared_memory_and_scratch(shape):
    """The chain's ring, biases, bias-gradient sums, column-sum stages and
    barriers fit in a block's shared memory; the weight-gradient pass's ring
    too; the scratch holds one chunk of the operand slots, within its cap;
    the chunk is 2^18 points where that fits."""
    n, d_out, nb, nlz, w = shape
    plan = _plan(shape)
    assert plan.smem <= 232448 and plan.dw_smem <= 232448
    assert plan.smem == (1024 + plan.stages * plan.stage_bytes
                         + 4 * fm.fwd_bias_floats(nb, nlz)
                         + 4 * plan.consumers * (fm.bwd_db_floats(nb) + 2 * 512) + 16 * plan.stages)
    assert plan.n_slots == len(fm.bwd_slots(nb, nlz))
    assert plan.scratch_bytes == min(n, plan.chunk) * plan.n_slots * 128 * 2
    assert plan.scratch_bytes <= fm.BWD_SCRATCH_CAP
    if plan.n_slots * 128 * 2 * fm.BWD_CHUNK <= fm.BWD_SCRATCH_CAP:
        assert plan.chunk == fm.BWD_CHUNK
    if (nb, nlz) == (5, 3):
        assert plan.n_slots == 19  # relu(x_i) 5, relu(x_L), relu(net_i) 5, dnet 5, dx 3


@pytest.mark.parametrize("dh,d_in,d_out,widths,n_blocks,legacy", [
    (128, 63, 24, None, 5, False),
    (128, 63, 24, FLAGSHIP, 5, False),
    (128, 64, 64, (64,), 5, False),
    (64, 63, 16, None, 5, True),
    (32, 63, 16, None, 5, True),
    (128, 63, 16, (16, 32, 48), 5, True),         # levels not multiples of 64
    (128, 63, 16, (128, 128, 256, 64), 5, True),  # four levels
    (128, 65, 16, None, 5, True),                 # d_in past the 64-row W_in
    (128, 63, 16, None, 7, False),
    (128, 63, 16, None, 8, True),                 # past the chain's shared memory
    (128, 63, 16, (4096,), 5, True),              # past the job table
])
def test_legacy_exactly_where_the_plan_says(dh, d_in, d_out, widths, n_blocks, legacy):
    plan = fm.bwd_plan(4099, d_in, dh, n_blocks, min(3, n_blocks), d_out, widths)
    assert plan.legacy == legacy
    if legacy:
        assert plan == fm.legacy_bwd_plan(4099)


@pytest.mark.parametrize("nb,nlz,widths", [(5, 3, None), (5, 3, FLAGSHIP), (5, 0, None),
                                           (5, 1, FLAGSHIP), (0, 0, None), (2, 2, (64, 192))])
def test_job_table(nb, nlz, widths):
    """One job per dW block, laid out back to back in the params' order;
    each reads a distinct scratch slot as A, and the gradients the plain
    backward multiplies: G of fc_1_i is dt_{i + 1} while that is injected,
    lin_in's is dt_0 with any injection; the lin_z kernels' jobs read the
    latent levels in 128-row pieces against dt_i."""
    slots = fm.bwd_slots(nb, nlz)
    assert sorted(slots.values()) == list(range(len(slots)))
    jobs = fm.bwd_jobs(nb, nlz, widths)
    out = 0
    for job in jobs:
        assert job[6] == out
        out += 64 * job[2] * 64 * job[5]
    assert fm.bwd_w_total(jobs) == out
    assert jobs[0][:3] == (fm.MAP_X, 0, 1)
    assert jobs[0][3:6] == ((fm.MAP_DT, 0, 2) if nlz else (fm.MAP_SCRATCH, 128 * slots["dx_in"], 2))
    for i in range(nb):
        fc0, fc1 = jobs[1 + 2 * i], jobs[2 + 2 * i]
        assert fc0[:6] == (0, 128 * slots[f"ax_{i}"], 2, 0, 128 * slots[f"dnet_{i}"], 2)
        want = ((fm.MAP_DT, 128 * (i + 1), 2) if i + 1 < nlz
                else (fm.MAP_SCRATCH, 128 * slots[f"dxe_{i}"], 2))
        assert fc1[:3] == (0, 128 * slots[f"an_{i}"], 2) and fc1[3:6] == want
    assert jobs[2 * nb + 1][:6] == (0, 128 * slots["ax_L"], 2, fm.MAP_G, 0, 1)
    zjobs = jobs[2 * nb + 2:]
    if widths is None or nlz == 0:
        assert not zjobs
        return
    rows = [64 * j[2] for j in zjobs]
    assert sum(rows) == nlz * sum(widths)
    for j in zjobs:
        assert j[3] >= 0 and j[3:6] in [(fm.MAP_DT, 128 * i, 2) for i in range(nlz)]


def _params(g, nb, nlz, d_out, d_lat, d_in=63, dh=128):
    def lin(din, dout):
        return {"kernel": torch.randn((din, dout), generator=g) / math.sqrt(din),
                "bias": 0.1 * torch.randn((dout,), generator=g)}

    p = {"lin_in": lin(d_in, dh), "lin_out": lin(dh, d_out)}
    for i in range(nlz):
        p[f"lin_z_{i}"] = lin(d_lat, dh) if d_lat else {"bias": lin(1, dh)["bias"]}
    for i in range(nb):
        p[f"blocks_{i}_fc_0"] = lin(dh, dh)
        p[f"blocks_{i}_fc_1"] = lin(dh, dh)
    return p


def _rb(a):
    return a.to(torch.bfloat16).float()


def _decomposed(plan, params, cfg, lat, x, g, d_out, proj):
    """The wgmma backward's arithmetic in torch: the chain's operands
    (scratch slots, dt) and float32 bias sums, the weight-gradient jobs over
    each chunk's splits, the splits summed in order, then the chunks; the
    output unpacked by `_unpack_bwd`. Projection mode: dz per 64 latent
    columns, the slices summed in order. Returns (grads, dt or dz)."""
    nb, nlz = cfg.n_blocks, fm._n_lin_z(cfg)
    x2 = x.reshape(-1, x.shape[-1])
    n, d_in = x2.shape
    inj = (fm._injection_plain(params, cfg, n, z=lat) if proj
           else fm._injection_plain(params, cfg, n, tz=lat))
    h, saved = fm._trunk_plain(params, cfg, inj, x2)
    slots = fm.bwd_slots(nb, nlz)
    scratch = torch.zeros((n, 128 * plan.n_slots))
    dt = torch.zeros((n, 128 * nlz))

    def put(name, v):
        scratch[:, 128 * slots[name]:128 * (slots[name] + 1)] = _rb(v)

    def w(name):
        return _rb(params[name]["kernel"])

    for i, (x_in, net) in enumerate(saved):
        put(f"ax_{i}", torch.relu(x_in))
        put(f"an_{i}", torch.relu(net))
    put("ax_L", torch.relu(h))
    g2 = _rb(g.reshape(n, d_out))
    db = torch.zeros(fm.bwd_db_floats(nb))
    db[128 * (1 + 2 * nb):128 * (1 + 2 * nb) + d_out] = g2.sum(0)
    dx = (g2 @ w("lin_out").t()) * (h > 0)
    for i in reversed(range(nb)):
        x_in, net = saved[i]
        if i + 1 >= nlz:
            put(f"dxe_{i}", dx)
        db[128 * (2 + 2 * i):128 * (3 + 2 * i)] = dx.sum(0)
        dnet = (_rb(dx) @ w(f"blocks_{i}_fc_1").t()) * (net > 0)
        db[128 * (1 + 2 * i):128 * (2 + 2 * i)] = dnet.sum(0)
        put(f"dnet_{i}", dnet)
        dx = dx + (_rb(dnet) @ w(f"blocks_{i}_fc_0").t()) * (x_in > 0)
        if i < nlz:
            dt[:, 128 * i:128 * (i + 1)] = _rb(dx)
    db[:128] = dx.sum(0)
    if nlz == 0:
        put("dx_in", dx)
    maps = {fm.MAP_SCRATCH: scratch, fm.MAP_DT: dt, fm.MAP_X: F.pad(_rb(x2), (0, 64 - d_in)),
            fm.MAP_G: F.pad(g2, (0, 64 - d_out))}
    levels = fm._levels(lat) if proj else []
    for lvl, zl in enumerate(levels):
        maps[fm.MAP_Z + lvl] = _rb(zl.reshape(n, -1))
    total = None
    for c0, nc, _, splits, per in plan.chunks(n):
        chunk = torch.zeros(plan.w_total)
        for s in range(splits):
            rows = slice(c0 + 64 * per * s, min(c0 + nc, c0 + 64 * per * (s + 1)))
            part = torch.zeros(plan.w_total)
            for am, ac, ah, gm, gc, gh, out in plan.jobs:
                a = maps[am][rows, ac:ac + 64 * ah]
                gg = maps[gm][rows, gc:gc + 64 * gh]
                part[out:out + 64 * ah * 64 * gh] = (a.t() @ gg).reshape(-1)
            chunk = part if s == 0 else chunk + part
        total = chunk if total is None else total + chunk
    d_lat = sum(zl.shape[-1] for zl in levels) if proj and nlz else 0
    grads = fm._unpack_bwd(torch.cat([total, db]), plan, params, cfg, d_in, d_out, d_lat)
    if not proj:
        return grads, dt.to(torch.bfloat16).reshape(lat.shape)
    wz = torch.cat([w(f"lin_z_{i}") for i in range(nlz)], dim=1) if nlz else None
    dzs, r = [], 0
    for zl in levels:
        c = zl.shape[-1]
        dz = torch.zeros((n, c))
        for c0 in range(0, c, 64):
            for i in range(nlz):
                dz[:, c0:c0 + 64] += dt[:, 128 * i:128 * (i + 1)] @ wz[r + c0:r + c0 + 64,
                                                                        128 * i:128 * (i + 1)].t()
        dzs.append(dz.to(zl.dtype).reshape(zl.shape))
        r += c
    return grads, (tuple(dzs) if isinstance(lat, tuple) else dzs[0])


@pytest.mark.parametrize("proj", [False, True], ids=["tz", "proj"])
@pytest.mark.parametrize("nlz", [0, 3])
@pytest.mark.parametrize("d_out", [1, 16, 24])
def test_decomposition_matches_plain(proj, nlz, d_out):
    """The two passes' arithmetic over 3 chunks of 256 points, 3 splits of
    64-point tiles each, against fused_resnet_fc_{tz_,}bwd_plain: the same
    float32 products, summed in another order (1e-5 of each leaf's scale);
    dt / dz the same bf16 values up to that order."""
    g = torch.Generator().manual_seed(7 + d_out + nlz)
    n, nb = 700, 5
    widths = (64, 128, 64) if proj else None
    cfg = MlpCfg(n_blocks=nb, d_hidden=128, combine_layer=nlz)
    params = _params(g, nb, nlz, d_out, sum(widths) if proj else 0)
    x = (torch.rand((n, 63), generator=g) * 2 - 1).to(torch.bfloat16)
    gy = torch.randn((n, d_out), generator=g)
    if proj:
        lat = tuple(torch.randn((n, c), generator=g).to(torch.float32 if i == 2 else torch.bfloat16)
                    for i, c in enumerate(widths))
        plain = fm.fused_resnet_fc_bwd_plain
    else:
        lat = torch.randn((n, 128 * nlz), generator=g).to(torch.bfloat16)
        plain = fm.fused_resnet_fc_tz_bwd_plain
    plan = fm.bwd_plan(n, 63, 128, nb, nlz, d_out, widths)._replace(chunk=256, splits=3)
    assert [c[3] for c in plan.chunks(n)] == [3, 3, 3]
    grads, dlat = _decomposed(plan, params, cfg, lat, x, gy, d_out, proj)
    want, pdlat = plain(params, cfg, lat, x, gy, d_out)
    assert set(grads) == set(want)
    for layer, leaves in want.items():
        assert set(grads[layer]) == set(leaves), layer
        for leaf, v in leaves.items():
            got = grads[layer][leaf]
            assert got.shape == v.shape and got.dtype == torch.float32, (layer, leaf)
            scale = float(v.abs().max().clamp_min(1e-30))
            assert float((got - v).abs().max()) <= 1e-5 * scale, (layer, leaf)
    for a, b in zip(dlat if proj else (dlat,), pdlat if proj else (pdlat,)):
        assert a.dtype == b.dtype and a.shape == b.shape
        if b.numel():
            ref = b.float()
            assert float((a.float() - ref).abs().max()) <= 1e-2 * float(ref.abs().max())


class _FakeLib:
    def __init__(self):
        self.calls = []

    def call(self, name, *args):
        self.calls.append((name, args))


@pytest.fixture
def fake_card(monkeypatch):
    """The backward wrappers' host side on CPU tensors: no device checks, no
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
    """Each backward wrapper calls the wgmma entry point with the plan's
    chunk, grid, shared memory, splits and job table, or the legacy one,
    counts the launch (and a legacy launch) on itself, and returns every
    leaf's gradient in the params' shapes."""
    n, d_out = 4099, 24
    g = torch.Generator().manual_seed(2)
    d_lat = sum(widths) if proj else 0
    params = _params(g, 5, 3, d_out, d_lat, dh=dh)
    cfg = MlpCfg(n_blocks=5, d_hidden=dh, combine_layer=3)
    x = torch.rand((n, 63), generator=g).to(torch.bfloat16)
    gy = torch.randn((n, d_out), generator=g)
    if proj:
        lat = tuple(torch.randn((n, c), generator=g).to(torch.float32 if i == len(widths) - 1
                                                          else torch.bfloat16)
                    for i, c in enumerate(widths))
        wrapper, fn, plain = fm.fused_resnet_fc_bwd, fm._fused_resnet_fc_bwd_cuda, \
            fm.fused_resnet_fc_bwd_plain
    else:
        lat = torch.randn((n, 3 * dh), generator=g).to(torch.bfloat16)
        wrapper, fn, plain = fm.fused_resnet_fc_tz_bwd, fm._fused_resnet_fc_tz_bwd_cuda, \
            fm.fused_resnet_fc_tz_bwd_plain
    plan = fm.bwd_plan(n, 63, dh, 5, 3, d_out, widths)
    n0, l0 = wrapper.launches, wrapper.legacy_launches
    grads, dlat = fn(params, cfg, lat, x, gy, d_out)
    ((name, args),) = fake_card.calls
    assert (wrapper.launches - n0, wrapper.legacy_launches - l0) == (1, int(plan.legacy))
    want, pdlat = plain(params, cfg, lat, x, gy, d_out)
    for layer, leaves in want.items():
        for leaf, v in leaves.items():
            assert grads[layer][leaf].shape == v.shape, (layer, leaf)
    for a, b in zip(dlat if proj else (dlat,), pdlat if proj else (pdlat,)):
        assert a.shape == b.shape and a.dtype == b.dtype
    if plan.legacy:
        assert name == ("njf_field_mlp_bwd" if proj else "njf_field_mlp_tz_bwd")
        return
    assert name == "njf_field_mlp_bwd_wg" and args[0] == int(proj)
    assert args[13:15] == ((len(widths), 1 << (len(widths) - 1)) if proj else (0, 0))
    assert args[22:24] == (len(plan.jobs), plan.w_total)
    assert args[27:] == (n, 5, 3, plan.chunk, plan.grid, plan.smem, plan.splits, plan.dw_smem, 0)
