"""The port's exact feature path (`pixel_feature_mode: "exact"`: per-sample
pyramid lookups, trunks that project each point's 512-channel latent)
against the benchmark's plain reference of it (portbench/reference/exact.py)
on the CPU, in float32, at a tiny cut of the `allegro_exact` configuration:
the lookups, one whole stage-1 step (losses, the gradient of every trained
leaf, the BatchNorm statistics), the epipolar path held outside the same
tolerances, and the programs' `pixel_gathers` counter. No JAX."""

import copy
import sys
import time
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench.harness import cells, context  # noqa: E402
from portbench.harness.program import build_model  # noqa: E402
from portbench.kinds import train_program as base  # noqa: E402
from portbench.kinds import train_program_exact as exact_kind  # noqa: E402
from portbench.reference import exact as ref  # noqa: E402
from portbench.reference.model import bilinear, encode, Precision  # noqa: E402

SEED = 2 ** 31 + 4409
HW = (64, 96)
PROPOSAL, NERF, BATCH, RAYS = 16, 16, 2, 8
# Float32 on both sides, the program's sums in other orders. The proposal
# samples' features agree to ~1e-5 of their scale, but the NeRF samples are
# the inverse CDF of the proposal weights, which moves a sample by ~1e-4 m
# (~2e-3 fine pixels) for a float32 rounding of a weight, and the depth
# loss's Gaussian (sigma 1e-3 m) turns such moves into loss and gradient
# gaps: over five seeds the losses were 2e-6 to 2.4e-4 apart and the worst
# leaf's gradient 0.001 to 0.076 of its norm (the density head's), while the
# epipolar path read 0.047 to 0.47 and 0.82 to 2.3. The limits sit 8x and
# 3x above the first and 20x and 3x below the second. The BatchNorm
# statistics come before any sampling: 3.9e-6 to 5.0e-6 of their change,
# a sum of the encoder's activations in another order (limit 10x).
LOSS_TOL, GRAD_TOL, STATS_TOL = 2e-3, 0.25, 5e-5


def tiny_cell(mode: str = "exact"):
    """`allegro.stage1_exact` cut to a size the CPU runs in a second, with one
    update step a call (gate True: the proposal trunk trains too), Adam's
    second moments at zero and the program's feature path set to `mode`."""
    cell = copy.deepcopy(cells.resolve("allegro.stage1_exact"))
    cfg, tr = cell.config, cell.traffic
    cfg["dtype"] = "float32"
    cfg["image_hw"] = list(HW)
    r = cfg["model"]["rendering"]
    r["num_proposal_samples"], r["num_nerf_samples"] = [PROPOSAL], NERF
    r["epipolar_knots"] = [8, 4, 2]
    r["pixel_feature_mode"] = mode
    tr.update(batch=BATCH, rays=RAYS, steps_per_call=1, gates=[True], pool=1, adam_v0_rms=0.0)
    return cell


def one_step(cell):
    """One step of the port's program from the seeded start, and the
    reference's from the same start on the same batch and draws: (start,
    the program's record, the reference's)."""
    from neural_jacobian_field_torch.training import TrainCfg, create_train_state, make_train_step

    torch.manual_seed(0)
    dev = torch.device("cpu")
    tr = cell.traffic
    weights = base.weights_for(cell, SEED, dev)
    start = {"params": {k: v.clone() for k, v in weights.items()}, "m": None, "v": None,
             "count": float(tr["start_step"])}
    model = build_model(cell.config, weights, dev)
    cfg = TrainCfg(mode=tr["mode"], lr=tr["lr"], warm_up_steps=tr["warm_up_steps"],
                   rays_per_batch=tr["rays"])
    state = create_train_state(model, cfg)
    state.optimizer.prepare().fill_(float(tr["start_step"]))
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    entry = base.make_entry(tr, cell.config, g, dev)
    batch = base._raw_batch({n: (None if v is None else v[0]) for n, v in entry.items()
                             if n in base._BATCH_FIELDS})
    step = make_train_step(model, cfg, static_updated=True)
    metrics = step(state, batch, yx=entry["yx"][0], draws=[d[0] for d in entry["draws"]])
    got = base._record(state, {"loss/total": metrics["loss/total"][None]})
    want = exact_kind.reference_call(cell, entry, start, dev)
    return start, got, want


def gaps(start, got, want):
    """Loss: relative gap; gradients: each trained leaf's first moment (0.1
    x its gradient with the weight decay) against the reference's, the
    norm of the difference over the larger of the leaf's norm and the
    median leaf's; BatchNorm statistics: each running buffer's change
    likewise."""
    import statistics

    loss = abs(got["loss"][0] - want["loss"][0]) / abs(want["loss"][0])
    norms = {n: float(m.norm()) for n, m in want["m"].items()}
    med = statistics.median(norms.values())
    grad = {n: float((got["m"][n] - want["m"][n]).norm()) / max(norms[n], med)
            for n in want["m"]}
    before = start["params"]
    change = {n: want["params"][n] - before[n] for n in before if "running_" in n}
    cmed = statistics.median(float(c.norm()) for c in change.values())
    stats = {n: float((got["params"][n] - want["params"][n]).norm()) / max(float(c.norm()), cmed)
             for n, c in change.items()}
    return loss, grad, stats


@pytest.fixture(scope="module")
def exact_step():
    return one_step(tiny_cell("exact"))


def test_reference_lookup_is_bilinear_on_each_level():
    """The reference's per-level lookup against an independent formula:
    each level through F.grid_sample (align_corners=True, border padding)
    at the level's own pixel, c = (f + 0.5) / s - 0.5, points outside the
    image included."""
    g = torch.Generator().manual_seed(5)
    pyr = (torch.randn(2, 24, 32, 5, generator=g), torch.randn(2, 6, 8, 3, generator=g),
           torch.randn(2, 3, 4, 4, generator=g))
    fx = torch.rand(2, 300, generator=g) * 40.0 - 4.0
    fy = torch.rand(2, 300, generator=g) * 32.0 - 4.0
    got = ref.pyramid_features(pyr, fx, fy)
    want = []
    for level, stride in zip(pyr, (1, 4, 8)):
        h, w = level.shape[1:3]
        cx, cy = (fx + 0.5) / stride - 0.5, (fy + 0.5) / stride - 0.5
        grid = torch.stack([2.0 * cx / (w - 1) - 1.0, 2.0 * cy / (h - 1) - 1.0], dim=-1)
        s = F.grid_sample(level.permute(0, 3, 1, 2), grid[:, None], mode="bilinear",
                          padding_mode="border", align_corners=True)
        want.append(s[:, :, 0].permute(0, 2, 1))
    torch.testing.assert_close(got, torch.cat(want, dim=-1), rtol=1e-5, atol=1e-5)


def test_port_lookup_is_the_references():
    """The port's `pyramid_pixel_levels` (2x2-packed rows on fine and mid, K1's
    plain version on coarse) equals the reference's lookup on the same
    float32 pyramid, at points inside and outside the image."""
    from neural_jacobian_field_torch.ops.pixel_gather import (
        FeaturePyramid, pack_pyramid, pyramid_pixel_levels)

    g = torch.Generator().manual_seed(6)
    fine, mid, coarse = (torch.randn(2, 32, 48, 128, generator=g),
                         torch.randn(2, 8, 12, 128, generator=g),
                         torch.randn(2, 4, 6, 256, generator=g))
    fx = torch.rand(2, 200, generator=g) * 56.0 - 4.0
    fy = torch.rand(2, 200, generator=g) * 40.0 - 4.0
    got = torch.cat([t.float() for t in pyramid_pixel_levels(
        pack_pyramid(FeaturePyramid(fine, mid, coarse)), fx, fy)], dim=-1)
    want = ref.pyramid_features((fine, mid, coarse), fx, fy)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_reference_field_reads_every_level():
    """ExactField's latent is the three levels' lookups at the points'
    projections (512 channels at the cell's widths), whatever ray a point
    lies on."""
    cell = tiny_cell()
    p = base.weights_for(cell, SEED, torch.device("cpu"))
    img = torch.rand(1, *HW, 3, generator=torch.Generator().manual_seed(1))
    pyr = encode(p, img, 4, False, Precision(), {})
    assert [t.shape[-1] for t in pyr] == [128, 128, 256]
    f = ref.ExactField(cell.config["model"], p, Precision())
    ext = torch.eye(4)[None]
    intr = torch.tensor([[[1.2, 0.0, 0.5], [0.0, 1.6, 0.5], [0.0, 0.0, 1.0]]])
    pos = torch.randn(1, 3, 5, 3, generator=torch.Generator().manual_seed(2)) * 0.3
    pos[..., 2] += 2.0
    z, pe = f.point_inputs(pyr, pos, ext, intr)
    assert z.shape == (1, 15, 512) and pe.shape == (1, 15, 63)
    uv = pos.reshape(1, 15, 3) @ intr[0].T
    uv = uv[..., :2] / uv[..., 2:]
    hf, wf = pyr[0].shape[1:3]
    fx, fy = uv[..., 0] * (wf - 1), uv[..., 1] * (hf - 1)
    torch.testing.assert_close(z[..., :128], bilinear(pyr[0], fx, fy), rtol=1e-5, atol=1e-5)


def test_exact_step_matches_the_reference(exact_step):
    """One stage-1 update step of the port's exact path from seeded weights:
    the loss, the gradient of every trained leaf and the BatchNorm running
    statistics agree with the reference's within float32's reordering."""
    start, got, want = exact_step
    loss, grad, stats = gaps(start, got, want)
    assert len(grad) == len([n for n in start["params"] if "running_" not in n])
    worst = max(grad, key=grad.get)
    assert loss <= LOSS_TOL, loss
    assert grad[worst] <= GRAD_TOL, (worst, grad[worst])
    assert max(stats.values()) <= STATS_TOL, max(stats.items(), key=lambda kv: kv[1])


def test_epipolar_step_is_outside_the_tolerances():
    """The same step with the epipolar path (ray knots, K7-tz's form) from
    the same weights and draws is held to the exact reference and fails:
    the knots' interpolation is not the per-sample lookup."""
    start, got, want = one_step(tiny_cell("epipolar"))
    loss, grad, _ = gaps(start, got, want)
    assert loss > LOSS_TOL, loss
    assert max(grad.values()) > GRAD_TOL, max(grad.values())


@pytest.mark.parametrize("mode,levels", [("exact", 3), ("epipolar", 0)])
def test_pixel_gathers_counts_points_times_levels(mode, levels, monkeypatch):
    """`pixel_gathers` of a train program: the per-sample pyramid lookups of
    one run of its body, points x levels (the proposal and the NeRF samples
    of each step), and 0 in an epipolar program."""
    from neural_jacobian_field_torch.utils import profiling

    cell = tiny_cell(mode)
    cell.traffic.update(steps_per_call=2, gates=[False, True], pool=1)
    monkeypatch.setattr(profiling, "_REG", profiling._Registry())
    ctx = context.RunContext(cell=cell, seed=SEED, seconds=0.0, trace=False,
                             device=torch.device("cpu"), t0=time.perf_counter())
    base.setup(ctx)
    (counts,) = [c for k, c in profiling.counters().items() if k.startswith("train#")]
    points = 2 * BATCH * RAYS * (PROPOSAL + NERF)
    assert counts["pixel_gathers"] == levels * points


def test_work_exact_trunk_flops_are_the_references():
    """harness/work_exact's trunk operations a point against
    torch.utils.flop_counter over the reference's trunk on the 512-channel
    latent: the layers and each combine layer's projection of the point's
    own latent."""
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.harness import work_exact
    from portbench.reference.model import trunk

    cell = tiny_cell()
    model = cell.config["model"]
    p = base.weights_for(cell, SEED, torch.device("cpu"))
    mlp = model["action_decoder"]["mlp"]
    n = 100
    z, x = torch.randn(1, n, 512), torch.randn(1, n, 63)
    with FlopCounterMode(display=False) as counter:
        trunk(p, "decoder.density_head", mlp, z, x, Precision())
    assert counter.get_total_flops() == work_exact.trunk_point_flops(model, mlp, 16) * n


def test_work_exact_gather_bytes_by_hand():
    """The lookups' and scatters' bytes at the cell's 480x640 image: the
    pyramid's shapes, and one call of 1,000 points on one image counted by
    hand (fine and mid: an id and a packed 1 KB bf16 row each; coarse: four
    ids, four weights and 256 float32; the scatters add each map's packed
    gradient once)."""
    from portbench.harness import work_exact

    model = cells.resolve("allegro.stage1_exact").config["model"]
    assert work_exact.pyramid_hw(480, 640) == ((240, 320), (60, 80), (30, 40))
    fwd = 1000 * ((8 + 1024) * 2 + 32 + 16 + 1024)
    assert work_exact.gather_bytes(model, 480, 640, 1, 1000, False) == fwd
    maps = (240 * 320 * 1024 + 60 * 80 * 1024 + 30 * 40 * 512)
    bwd = 1000 * ((8 + 1024) * 2 + 32 + 16 + 512) + maps
    assert work_exact.gather_bytes(model, 480, 640, 1, 1000, True) == bwd
