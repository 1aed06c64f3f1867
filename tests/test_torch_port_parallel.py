"""Data parallelism of the port (parallel/mesh.py) on the CPU: two gloo ranks,
each a fresh process (parallel/launch.py: a file:// rendezvous under a
fresh directory, a time limit), against the JAX package's step on the
global batch, which is what JAX's SPMD step over a sharded batch computes,
and against the port's own one-process step.

Shapes of the JAX dry run (`__graft_entry__.dryrun_multichip`): 16x16
images, a 2-stage BatchNorm encoder, epipolar knots (8, 4, 2), 4 + 4
samples, 16 rays; the trunks of tests/_torch_port_common.py (2 x 32).
Inputs from a numpy seed, the weights seeded numpy draws handed to the port
through utils/from_jax.py. A global batch of 2: each rank holds one image,
so BatchNorm's statistics, the masked tracks loss and the metrics are wrong
unless they are the global batch's.

Tolerances: against JAX, those of tests/test_torch_port_train_step.py and
tests/test_torch_port_action.py (metrics 5e-3 of scale; parameters on the
lr scale; running statistics 1e-5), with the anneal exponent held at ~0 and
a small lr, for the reasons given there; the render at
tests/test_torch_port_model.py's field tolerance (5e-3 of scale). Against
the port's one-process step the same float32 operations run, only the
summation order differs (a mean of the ranks' gradient and statistics sums
in place of one sum over the batch): loss, metrics, gradients and running
statistics within 1e-5 of each tensor's scale (measured: up to 1.9e-6,
gradients of the tracks step; statistics 2e-7), and the parameters after
Adam within 5e-2 of the lr (measured: 1.0e-2 lr, where Adam normalises a
gradient element near 0).
"""

import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_parallel_workers as W
from _torch_port_common import (INTRINSICS, jax_model_cfg, look_at_offset, randomize_variables,
                                torch_model_cfg)
from neural_jacobian_field_torch.parallel import launch
from neural_jacobian_field_torch.utils.from_jax import from_jax_variables

HW, RAYS, TRACKS, B = 16, 16, 16, 2
LR, WARMUP = 1e-4, 4
TOL, STATS_TOL, SELF_TOL, SELF_LR_TOL = 5e-3, 1e-5, 1e-5, 5e-2
SAMPLES = (4, 4)
CLI_LR = 1e-3


def _cfgs():
    """JAX's and the port's model config at the dry run's shapes."""
    rendering = dict(num_proposal_samples=(SAMPLES[0],), num_nerf_samples=SAMPLES[1],
                     proposal_weights_anneal_max_num_iters=10 ** 9)
    j, t = jax_model_cfg(), torch_model_cfg()
    return (replace(j, rendering=replace(j.rendering, **rendering),
                    encoder=replace(j.encoder, num_layers=2)),
            replace(t, rendering=replace(t.rendering, **rendering),
                    encoder=replace(t.encoder, num_layers=2)))


def _arrays(seed, tracks=False):
    rng = np.random.default_rng(seed)
    a = dict(
        ctxt_rgb=rng.integers(0, 256, size=(B, HW, HW, 3), dtype=np.uint8),
        ctxt_extrinsics=np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy(),
        ctxt_intrinsics=np.broadcast_to(INTRINSICS, (B, 3, 3)).copy(),
        robot_action=rng.normal(size=(B, 4)).astype(np.float32),
        trgt_rgb=rng.integers(0, 256, size=(B, HW, HW, 3), dtype=np.uint8),
        trgt_depth=rng.uniform(1.0, 3.5, size=(B, HW, HW, 1)).astype(np.float32),
        trgt_extrinsics=np.stack([look_at_offset(10.0), look_at_offset(-8.0)]),
        trgt_intrinsics=np.broadcast_to(INTRINSICS, (B, 3, 3)).copy(),
        near=np.full((B,), 0.5, np.float32), far=np.full((B,), 4.0, np.float32))
    if tracks:
        a["pixel_selector"] = rng.integers(0, HW * HW, size=(B, TRACKS)).astype(np.int32)
        a["pixel_motion"] = (3.0 * rng.normal(size=(B, TRACKS, 2))).astype(np.float32)
        mask = np.zeros((B, TRACKS), np.float32)
        mask[0, :14] = 1.0  # rank 0's image: 14 visible tracks; rank 1's: 3
        mask[1, 5:8] = 1.0
        a["pixel_visible_mask"] = mask
    return a


def _draws(key, arrays):
    """The JAX step's pixel set and stratified jitter, from its own key."""
    k_prep, k_samp = jax.random.split(key)
    n = arrays["pixel_selector"].shape[1] if "pixel_selector" in arrays else RAYS
    yx = jax.random.uniform(k_prep, (RAYS, 2)) * jnp.array([HW, HW], jnp.float32)
    keys = jax.random.split(k_samp, len(SAMPLES))
    draws = [jax.random.uniform(k, (B, n, s + 1)) for k, s in zip(keys, SAMPLES)]
    return (torch.from_numpy(np.array(yx.astype(jnp.int32))),
            tuple(torch.from_numpy(np.array(d)) for d in draws))


def _render_arrays():
    rng = np.random.default_rng(5)
    return dict(image=rng.uniform(size=(1, HW, HW, 3)).astype(np.float32),
                ctxt=np.eye(4, dtype=np.float32)[None], trgt=look_at_offset(10.0)[None],
                intr=INTRINSICS[None], action=rng.normal(size=(1, 4)).astype(np.float32))


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Start the two ranks, compute the JAX steps and render and the port's
    one-process steps while they run, then collect the ranks' results."""
    from neural_jacobian_field_tpu.inference.render import render_camera as j_render
    from neural_jacobian_field_tpu.models import model as jm
    from neural_jacobian_field_tpu.training import prepare as jp
    from neural_jacobian_field_tpu.training import train as jt

    jcfg, tcfg = _cfgs()
    jmodel = jm.Model(cfg=jcfg)
    arrays = {"perception": _arrays(11), "tracks": _arrays(12, tracks=True)}
    jbatch = {k: jp.RawBatch(**{n: jnp.asarray(v) for n, v in a.items()})
              for k, a in arrays.items()}
    shapes = jax.eval_shape(lambda: jt.create_train_state(
        jax.random.PRNGKey(0), jmodel, jbatch["perception"],
        jt.TrainCfg(rays_per_batch=RAYS)))
    variables = randomize_variables({
        "params": jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes.params),
        "batch_stats": jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes.batch_stats)})
    keys = {"perception": jax.random.PRNGKey(21), "tracks": jax.random.PRNGKey(22)}
    setup = dict(cfg=tcfg, lr=LR, warmup=WARMUP, rays=RAYS,
                 state_dict=from_jax_variables(variables["params"], variables["batch_stats"]),
                 render=dict(arrays=_render_arrays(), near=0.5, far=4.0, hw=(HW, HW), patch=64),
                 **{k: dict(arrays=a, draws=_draws(keys[k], a)) for k, a in arrays.items()})
    ranks = launch.start(W.steps_rank, 2, args=(setup,), timeout_s=240, threads=1)

    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    jax_steps = {}
    for kind, mode in (("perception", "perception"), ("tracks", "action")):
        tc = jt.TrainCfg(mode=mode, lr=LR, warm_up_steps=WARMUP, rays_per_batch=RAYS)
        st = jt.create_train_state(jax.random.PRNGKey(0), jmodel, jbatch[kind], tc,
                                   init_params=params, init_batch_stats=stats)
        step = jt.make_train_step(jmodel, tc, donate=False, static_updated=True)
        new, metrics = step(st, jbatch[kind], keys[kind])
        jax_steps[kind] = dict(new=new, metrics=metrics)
    r = _render_arrays()
    jcam = jm.CameraInput(input_image=jnp.asarray(r["image"]),
                          ctxt_extrinsics=jnp.asarray(r["ctxt"]),
                          ctxt_intrinsics=jnp.asarray(r["intr"]),
                          trgt_extrinsics=jnp.asarray(r["trgt"]),
                          trgt_intrinsics=jnp.asarray(r["intr"]))
    jax_render = j_render(jmodel, variables, jcam, jm.RobotInput(jnp.asarray(r["action"])),
                          0.5, 4.0, height=HW, width=HW, patch_size=64)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = {kind: W.one_step(setup, kind) for kind in ("perception", "tracks")}
        one["render"] = W.render(setup)
    finally:
        torch.set_num_threads(threads)
    return dict(ranks=ranks.join(), jax=jax_steps, jax_render=jax_render, one=one,
                variables=variables, setup=setup)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _lr_displacement_ok(got, start, want):
    """Adam's displacement on the lr scale (tests/test_torch_port_train_step.py):
    at most 1% of a tensor's elements further apart than 1e-2 lr, none
    beyond 2 lr."""
    err = np.abs((got - start) - (want - start)) / LR
    return int((err > 1e-2).sum()) <= max(1, err.size // 100) and err.max() <= 2.0 + 1e-3


@pytest.mark.parametrize("kind", ["perception", "tracks"])
def test_ranks_bit_for_bit_equal(dp, kind):
    """Both ranks hold the same parameters, buffers and metrics, bit for bit."""
    a, b = (r[kind] for r in dp["ranks"])
    assert a["metrics"] == b["metrics"]
    for part in ("params", "buffers", "grads"):
        assert a[part].keys() == b[part].keys()
        for name in a[part]:
            assert torch.equal(a[part][name], b[part][name]), (part, name)


@pytest.mark.parametrize("kind", ["perception", "tracks"])
def test_two_rank_step_matches_jax_global_batch(dp, kind):
    """The two-rank step against JAX's make_train_step on the global batch
    of 2: the loss and every metric, every parameter after Adam (stage 2:
    the Jacobian head moves, everything else stays bit for bit), and the
    running statistics."""
    got = dp["ranks"][0][kind]
    ref = dp["jax"][kind]
    assert set(got["metrics"]) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        assert abs(got["metrics"][k] - float(v)) <= TOL * max(abs(float(v)), 1e-3), (
            k, got["metrics"][k], float(v))
    start = dp["setup"]["state_dict"]
    want = from_jax_variables(jax.tree.map(np.asarray, ref["new"].params))
    for name, p in got["params"].items():
        if kind == "tracks" and "jacobian_head" not in name:
            assert torch.equal(p, start[name]), name
            continue
        assert _lr_displacement_ok(p.numpy(), start[name].numpy(), want[name].numpy()), name
    stats = from_jax_variables({}, jax.tree.map(np.asarray, ref["new"].batch_stats))
    for name, v in stats.items():
        assert _rel(got["buffers"][name], v) <= STATS_TOL, name


@pytest.mark.parametrize("kind", ["perception", "tracks"])
def test_two_rank_step_matches_one_process(dp, kind):
    """The two-rank step against the port's own step on the global batch in
    one process: float32 throughout, only the all-reduce's summation order
    between them."""
    got, want = dp["ranks"][0][kind], dp["one"][kind]
    assert (got["step"], got["ssu"]) == (want["step"], want["ssu"])
    for k, v in want["metrics"].items():
        assert abs(got["metrics"][k] - v) <= SELF_TOL * max(abs(v), 1e-3), k
    for part in ("grads", "buffers"):
        for name, v in want[part].items():
            assert _rel(got[part][name], v) <= SELF_TOL, (part, name)
    for name, v in want["params"].items():
        assert float((got["params"][name] - v).abs().max()) <= SELF_LR_TOL * LR, name


def test_tracks_loss_is_the_global_masked_mean(dp):
    """Rank 0's image holds 14 visible tracks, rank 1's 3: the loss is the
    global sum over the global count (JAX's), not the mean of the ranks'
    masked means, which differs here by far more than the tolerance."""
    got = dp["ranks"][0]["tracks"]["metrics"]["loss/flow"]
    want = float(dp["jax"]["tracks"]["metrics"]["loss/flow"])
    assert abs(got - want) <= TOL * abs(want)
    mask = dp["setup"]["tracks"]["arrays"]["pixel_visible_mask"]
    assert mask[0].sum() == 14 and mask[1].sum() == 3


def test_sharded_render_matches_jax_and_render_camera(dp):
    """render_camera_sharded over the two ranks (16x16, 32 rays a chunk a
    rank) bit for bit the port's render_camera in one process (64-ray
    chunks) on both ranks, and against JAX's render_camera: with 4 + 4
    samples a float32 rounding of a resampled position moves a few rays'
    composites (tests/test_torch_port_model.py: the top NeRF frequency), so
    at most 5% of the elements beyond the field tolerance (5e-3 of scale)
    and none beyond 5e-2 (measured: 2.1% of the rgb elements, at most
    1.6e-2 of scale; the median 2.7e-5)."""
    got, one, want = dp["ranks"][0]["render"], dp["one"]["render"], dp["jax_render"]
    assert got["rgb"].shape == (1, HW, HW, 3)
    for k in ("rgb", "depth_raw", "weights", "ray_positions"):
        w = np.asarray(getattr(want, k), np.float64)
        err = np.abs(got[k].numpy() - w) / np.abs(w).max()
        assert np.isfinite(err).all() and err.max() <= 10 * TOL, k
        assert (err > TOL).mean() <= 0.05, k
    for k, v in one.items():
        assert torch.equal(got[k], v), k
    for k, v in dp["ranks"][1]["render"].items():
        assert torch.equal(got[k], v), k


def test_shard_batch_slicing_and_errors():
    """Each rank's rows of dim 0 (shard_batch) or of dim 1 (a stack_batches
    result); a batch that does not divide over the ranks raises."""
    from neural_jacobian_field_torch.parallel import Mesh, shard_batch, shard_stacked_batch
    from neural_jacobian_field_torch.training import RawBatch, stack_batches

    batch = W._tensors(_arrays(3, tracks=True))
    stacked = stack_batches([batch, batch, batch])
    for rank in range(2):
        mesh = Mesh(group=None, rank=rank, size=2, device=torch.device("cpu"), backend="gloo")
        mine = shard_batch(batch, mesh)
        assert isinstance(mine, RawBatch) and mine.flow is None
        for name in ("ctxt_rgb", "pixel_selector", "near"):
            assert torch.equal(getattr(mine, name), getattr(batch, name)[rank:rank + 1])
        mine = shard_stacked_batch(stacked, mesh)
        assert mine.trgt_rgb.shape == (3, 1, HW, HW, 3)
        assert torch.equal(mine.trgt_rgb, stacked.trgt_rgb[:, rank:rank + 1])
    three = Mesh(group=None, rank=0, size=3, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(batch, three)
    with pytest.raises(ValueError, match="does not divide"):
        shard_stacked_batch(stacked, three)


def test_make_mesh_refuses_without_a_group_or_a_card(monkeypatch):
    """No torchrun environment and no init_method: an error, never a
    one-process fall-back; NCCL on the CPU: an error."""
    from neural_jacobian_field_torch.parallel import make_mesh

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh("cpu")
    with pytest.raises(RuntimeError, match="NCCL needs a CUDA device"):
        make_mesh("cpu", "file:///nonexistent", 0, 1, backend="nccl")


def test_dryrun_multigpu_two_ranks(capsys):
    """The dry run on two gloo ranks on the CPU: the perception step, the
    eval render from the updated statistics against one process, the
    tracks step."""
    from neural_jacobian_field_torch.parallel.dryrun import dryrun_multigpu

    out = dryrun_multigpu(2, device="cpu", timeout_s=240)
    lines = capsys.readouterr().out.splitlines()
    assert len([line for line in lines if line.startswith("dryrun_multigpu(2)")]) == 3
    assert np.isfinite(out["loss"]) and np.isfinite(out["loss_action"])


def test_dryrun_multigpu_runs_on_the_card_unless_asked(monkeypatch):
    """The dry run's default is the card, NCCL a card a rank: without a card
    it raises before it spawns a rank (never a silent CPU run), and NCCL
    ranks that would share a card raise naming the gloo route."""
    from neural_jacobian_field_torch.parallel import dryrun

    assert dryrun.dryrun_multigpu.__defaults__[0] == "cuda"
    monkeypatch.setattr(dryrun, "spawn", lambda *a, **k: pytest.fail("spawned ranks"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multigpu(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for device in ("cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="--device cuda:0 --backend gloo"):
            dryrun.dryrun_multigpu(2, device)
    dryrun.check_ranks(1, "cuda", None)
    dryrun.check_ranks(2, "cuda:0", "gloo")


def test_cli_two_ranks(tmp_path):
    """The training CLI as two gloo ranks for 4 steps of a global batch of 2
    (one image a rank), lr 1e-3 from the first step, a validation video
    after the last: the ranks end with equal parameters and statistics,
    rank 0 alone writes checkpoints, metrics, the validation frames and
    run.json, and the run trains on the batches a one-rank run makes from
    the same seed (each rank's loader makes its own rows, every item seeded
    by (seed, batch, row); a one-rank run is bit for bit the run without a
    mesh on those batches). After 4 Adam steps the two runs differ only by
    the all-reduce's summation order, which Adam amplifies on elements
    whose gradient is near 0: at most 20% of the parameters' elements
    further than 0.1 lr from the one-rank run's, and the median element
    within 0.02 lr (measured: 6.9%, median 0.0026 lr; after one step none
    beyond 0.1 lr. With both ranks on the same rows, or each rank's loader
    unsharded on its own global streams, so other batches: 56% / 0.18 lr
    and 64% / 0.44 lr)."""
    from neural_jacobian_field_torch.data import make_synthetic_scene

    scene = make_synthetic_scene(tmp_path / "scene", num_cameras=3, num_trajs=2,
                                 frames_per_traj=4, height=HW, width=HW, action_dim=4)
    overrides = ["dataset.num_total_joints=4", "dataset.disabled_joints=null",
                 "dataset.max_num_frames_per_traj=4", "model.action_dim=4",
                 "model.rendering.num_proposal_samples=[4]", "model.rendering.num_nerf_samples=4",
                 "model.encoder.num_layers=2", "model.encoder.norm_type=batch",
                 "training.data.batch_size=2", "training.data.rays_per_batch=16",
                 "training.data.num_workers=2", "training.max_steps=4",
                 "training.val_check_interval=4", "validation.video.num_frames=2",
                 "checkpoint.every_n_train_steps=2",
                 f"training.optim.lr={CLI_LR}", "training.optim.warm_up_steps=1"]
    two = launch.start(W.cli_rank, 2, args=(str(scene), overrides, str(tmp_path / "two")),
                       timeout_s=240, threads=1)
    one = launch.start(W.cli_rank, 1, args=(str(scene), overrides, str(tmp_path / "one")),
                       timeout_s=240, threads=1)
    a, b = two.join()
    (one,) = one.join()
    assert a["step"] == b["step"] == one["step"] == 4
    for name, v in a["params"].items():
        assert torch.equal(v, b["params"][name]), name
    work = tmp_path / "two"
    assert sorted(p.name for p in (work / "rank0" / "ck").iterdir()) == [
        "ckpt_000000002.pt", "ckpt_000000004.pt"]
    run = json.loads((work / "rank0" / "logs" / "run.json").read_text())
    assert run["ranks"] == 2 and run["batch_size"] == 2 and run["steps"] == 4
    assert len(run["validation_frames"]) == 6 and (work / "rank0" / "logs" / "val_4").is_dir()
    assert not (work / "rank1").exists()
    err = torch.cat([(a["params"][n] - v).abs().flatten() / CLI_LR
                     for n, v in one["params"].items() if "running" not in n])
    assert float((err > 0.1).float().mean()) <= 0.2 and float(err.median()) <= 0.02


def test_render_camera_pads_an_image_smaller_than_a_chunk():
    """A 4x4 view (16 rays) in chunks of 64 rays: the 48 padding rays cycle
    over the image's rays (the JAX package's pad repeats the first rays,
    which needs as many as the pad); the image equals the one rendered in
    chunks of 16 (no padding): bit for bit but for the flow, a difference of
    two projections of nearly the same points, whose matmuls block by a
    chunk's rows: within 1e-3 of its scale (measured 1.7e-4)."""
    from neural_jacobian_field_torch.inference.render import render_camera
    from neural_jacobian_field_torch.models.model import CameraInput, Model, RobotInput

    _, tcfg = _cfgs()
    model = Model(tcfg)
    model.init_weights(torch.Generator().manual_seed(0))
    t = {k: torch.from_numpy(v) for k, v in _render_arrays().items()}
    cam = CameraInput(input_image=t["image"], ctxt_extrinsics=t["ctxt"],
                      ctxt_intrinsics=t["intr"], trgt_extrinsics=t["trgt"],
                      trgt_intrinsics=t["intr"])
    a, b = (render_camera(model, cam, RobotInput(t["action"]), 0.5, 4.0, 4, 4, patch_size=p)
            for p in (64, 16))
    assert a.rgb.shape == (1, 4, 4, 3)
    for k, v in vars(b).items():
        if k == "flow_raw":
            assert float((a.flow_raw - v).abs().max()) <= 1e-3 * float(v.abs().max())
        else:
            assert torch.equal(getattr(a, k), v), k
