"""The port's training CLI and what it reaches, on the CPU: `main(["--device",
"cpu", ...])` at the e2e drive's configuration (a 2-layer BatchNorm encoder,
so the concat layout) with one and with six steps per call, writing logs,
validation frames and checkpoints, and the stage-2 warm start from a
checkpoint training the Jacobian head alone; `train()` without a device
raising where there is no card; the e2e drive (verify_e2e) at a reduced
step count, its own checks as gates; and the utilities the CLI calls
against the JAX package's: metrics (1e-6 relative), the sanity metrics'
names, the colormaps and the camera-path interpolation (exact), the
validation video's frames."""

import json
import math

import numpy as np
import pytest
import torch

from neural_jacobian_field_torch import train as cli

SCENE = dict(num_cameras=3, num_trajs=3, frames_per_traj=4, height=48, width=64, action_dim=4)
E2E = ["dataset.num_total_joints=4", "dataset.disabled_joints=null",
       "dataset.max_num_frames_per_traj=4", "model.action_dim=4",
       "model.rendering.num_proposal_samples=[8]", "model.rendering.num_nerf_samples=8",
       "model.encoder.num_layers=2", "model.encoder.norm_type=batch",
       "training.data.batch_size=2", "training.data.rays_per_batch=64",
       "training.data.num_workers=0", "validation.video.num_frames=2"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads while this file runs (the suite's workers share the
    machine's cores), restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from neural_jacobian_field_torch.data import make_synthetic_scene

    return make_synthetic_scene(tmp_path_factory.mktemp("scene"), **SCENE)


def _main(cwd, args):
    """cli.main with the working directory (the default logs/) at cwd."""
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(cwd)
        return cli.main(["--device", "cpu", *args])


@pytest.fixture(scope="module")
def stage1(scene, tmp_path_factory):
    """Stage 1 through the CLI: 100 steps of batch 1, one per call (a log
    point at step 100), a validation at step 100, checkpoints at steps 50
    and 100."""
    out = tmp_path_factory.mktemp("stage1")
    state = _main(out, [f"dataset.root={scene}", *E2E, "training.max_steps=100",
                        "training.data.batch_size=1", "training.data.rays_per_batch=32",
                        "training.val_check_interval=100", "checkpoint.dir=ck",
                        "checkpoint.every_n_train_steps=50"])
    return out, state


def test_cli_stage1_one_step_per_call(stage1):
    out, state = stage1
    assert state.step == 100 and state.model.cfg.encoder.num_layers == 2
    assert isinstance(state.model.encode_features(torch.zeros(1, 48, 64, 3)), torch.Tensor)
    rows = [json.loads(line) for line in (out / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [100]
    assert math.isfinite(rows[0]["loss/total"]) and rows[0]["perf/rays_per_sec"] > 0
    assert sorted(p.name for p in (out / "ck").iterdir()) == [
        "ckpt_000000050.pt", "ckpt_000000100.pt"]
    frames = sorted(p.name for p in (out / "logs" / "val_100").iterdir())
    assert frames == sorted(f"{n}_{t}.png" for n in ("rgb", "depth", "optical_flow")
                            for t in ("f0", "mid"))
    run = json.loads((out / "logs" / "run.json").read_text())
    assert run["steps"] == 100 and run["device"] == "cpu" and run["programs"] == 0
    assert sum(run["loader_paths"].values()) >= 100 and len(run["validation_frames"]) == 6


def test_cli_stage2_warm_start_freezes_all_but_the_head(scene, stage1, tmp_path):
    out, state1 = stage1
    want = {k: v.clone() for k, v in state1.model.state_dict().items()}
    state = _main(tmp_path, [f"dataset.root={scene}", *E2E, "dataset.mode=action",
                             f"checkpoint.load={out / 'ck'}", "checkpoint.dir=ck2",
                             "training.max_steps=4", "training.val_check_interval=0"])
    assert state.step == 4 and state.cfg.mode == "action"
    moved = [k for k, p in state.model.named_parameters() if not torch.equal(p, want[k])]
    assert moved and all(k.startswith("decoder.jacobian_head.") for k in moved), moved
    # the BatchNorm running statistics are the fresh model's, moved by stage 2
    assert not torch.equal(state.model.encoder.bn1.running_mean,
                           want["encoder.bn1.running_mean"])


def test_cli_six_steps_per_call_and_tracks(scene, stage1, tmp_path):
    """K = 6: a warm-up window of per-substep steps, then the dispatch's
    6-step programs (on the CPU run eagerly); validation at the crossing of
    step 12; then a stage-2 tracks run, the tracks padded to 1024."""
    out, _ = stage1
    state = _main(tmp_path, [f"dataset.root={scene}", *E2E, "training.steps_per_call=6",
                             "training.max_steps=24", "training.val_check_interval=12",
                             "model.rendering.proposal_warmup=6", "checkpoint.dir=ck6",
                             "checkpoint.every_n_train_steps=12"])
    assert state.step == 24
    assert sorted(p.name for p in (tmp_path / "ck6").iterdir()) == [
        "ckpt_000000012.pt", "ckpt_000000024.pt"]
    assert (tmp_path / "logs" / "val_12" / "rgb_f0.png").exists()
    state = _main(tmp_path, [f"dataset.root={scene}", *E2E, "dataset.mode=action",
                             "dataset.action_supervision_type=tracks",
                             f"checkpoint.load={out / 'ck'}", "checkpoint.dir=ck7",
                             "training.max_steps=2", "training.val_check_interval=0"])
    assert state.step == 2


def test_profile_traces_a_dispatch_of_the_steady_window(scene, tmp_path):
    """`--profile 1` traces the first dispatch after the first log point
    past the proposal warm-up (steps 100-101 here), not one after the run;
    the next window's rate restarts after it. The dispatches are stand-ins
    that only count steps, so the loop's schedule is what is tested; the
    trace is written to trace.json and run.json holds the span table and
    the counters."""
    from neural_jacobian_field_torch.config import CONFIG_DIR, get_typed_root_config, load_config

    cfg = get_typed_root_config(load_config(CONFIG_DIR, [
        f"dataset.root={scene}", *E2E, "model.rendering.proposal_warmup=6",
        "training.val_check_interval=0", "checkpoint.dir=ck",
        "checkpoint.every_n_train_steps=1000"]))
    trainer = cli.Trainer(cfg, max_steps_override=300, log_dir=tmp_path / "logs",
                          device="cpu")
    calls = []

    def dispatch():
        calls.append(trainer.state.step)
        trainer.state.step += 1
        return {"loss/total": torch.tensor(0.5)}

    trainer.dispatch = dispatch
    try:
        trainer.run(profile=1)
    finally:
        trainer.close()
    run = json.loads((tmp_path / "logs" / "run.json").read_text())
    assert run["profile"]["steps"] == [100, 101] and run["profile"]["dispatches"] == 1
    assert run["profile"]["idle_share"] is None  # no device on the CPU: not measured
    assert (tmp_path / "logs" / "trace.json").exists()
    assert {"host_spans", "programs", "counters"} <= set(run["profile"])
    assert set(run["profile"]["counters"]) == {"programs", "launches"}
    assert calls == list(range(300)) and run["steps"] == 300
    rows = [json.loads(line) for line in (tmp_path / "logs" / "metrics.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in rows] == [100, 200, 300]


def test_train_raises_without_a_card(scene, monkeypatch):
    from neural_jacobian_field_torch.config import CONFIG_DIR, get_typed_root_config, load_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_typed_root_config(load_config(CONFIG_DIR, [f"dataset.root={scene}", *E2E]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.train(cfg)
    with pytest.raises(SystemExit):
        cli.main(["--no-such-flag"])


def test_verify_e2e_drive_on_cpu(tmp_path):
    from neural_jacobian_field_torch.verify_e2e import run

    lines = []
    out = run("cpu", stage1_steps=30, stage2_steps=40, solve_iters=100, stabilizer_steps=3,
              root=tmp_path / "scene", log=lines.append)
    assert lines[-1] == "E2E VERIFY: ALL OK"
    assert len(out["stage1_rgb"]) == 30 and len(out["stage2_total"]) == 40
    assert out["frozen"] > 0 and out["trainable_moved"] > 0 and not out["frozen_moved"]
    assert out["flow_residual"] < 0.02


# ------------------------------------------------------------ utilities

def test_metrics_match_jax():
    import jax.numpy as jnp

    from neural_jacobian_field_tpu.utils import metrics as jm
    from neural_jacobian_field_torch.utils import metrics as tm

    rng = np.random.default_rng(0)
    a, b = rng.uniform(size=(2, 8, 3)), rng.uniform(size=(2, 8, 3))
    f, g = rng.normal(size=(5, 7, 2)), rng.normal(size=(5, 7, 2))
    mask = (rng.uniform(size=(5, 7)) > 0.4).astype(np.float32)
    pairs = [
        (tm.psnr(torch.tensor(a), torch.tensor(b)), jm.psnr(jnp.asarray(a), jnp.asarray(b))),
        (tm.flow_epe(torch.tensor(f), torch.tensor(g)),
         jm.flow_epe(jnp.asarray(f), jnp.asarray(g))),
        (tm.flow_epe(torch.tensor(f), torch.tensor(g), torch.tensor(mask)),
         jm.flow_epe(jnp.asarray(f), jnp.asarray(g), jnp.asarray(mask))),
        (tm.jacobian_error(torch.tensor(f), torch.tensor(g)),
         jm.jacobian_error(jnp.asarray(f), jnp.asarray(g))),
    ]
    for got, want in pairs:
        assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


def test_sanity_metric_names_match_jax(tmp_path):
    """The sanity/* stream's names for a ModelInput, as JAX's pytree paths
    name them; min/max values; the logger's JSONL; wandb off."""
    import jax.numpy as jnp

    from neural_jacobian_field_tpu.models import model as jmodel
    from neural_jacobian_field_tpu.utils.logging import get_sanity_metrics as jsanity
    from neural_jacobian_field_torch.models import model as tmodel
    from neural_jacobian_field_torch.utils.logging import (
        MetricsLogger, get_sanity_metrics, maybe_init_wandb)

    rng = np.random.default_rng(1)
    arr = {k: rng.normal(size=s).astype(np.float32) for k, s in (
        ("img", (1, 4, 5, 3)), ("e", (1, 4, 4)), ("i", (1, 3, 3)), ("o", (1, 6, 3)),
        ("near", (1,)), ("a", (1, 2)))}

    def build(m, conv):
        cam = m.CameraInput(conv(arr["img"]), conv(arr["e"]), conv(arr["i"]), conv(arr["e"]),
                            conv(arr["i"]))
        ri = m.RenderingInput(conv(arr["o"]), conv(arr["o"]), conv(arr["near"]),
                              conv(arr["near"]))
        return m.ModelInput(cam, ri, m.RobotInput(conv(arr["a"])))

    want = jsanity(build(jmodel, jnp.asarray), prefix="sanity/input_")
    got = get_sanity_metrics(build(tmodel, torch.from_numpy), prefix="sanity/input_")
    assert set(got) == set(want) and got == pytest.approx(want)
    logger = MetricsLogger(tmp_path, print_every=1)
    logger.log(3, {"loss": torch.tensor(0.5), "x": 2})
    logger.close()
    row = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert row["step"] == 3 and row["loss"] == 0.5 and row["x"] == 2.0
    from neural_jacobian_field_torch.config import WandbCfg

    assert maybe_init_wandb(WandbCfg()) is None


def test_colormaps_match_jax(monkeypatch):
    from neural_jacobian_field_tpu.inference import render as jr
    from neural_jacobian_field_torch.inference import render as tr

    rng = np.random.default_rng(2)
    depth = rng.uniform(0.5, 4.0, size=(12, 9, 1))
    flow = rng.normal(size=(12, 9, 2)) * 3
    assert np.array_equal(tr.depth_colormap(depth), jr.depth_colormap(depth))
    assert np.array_equal(tr.depth_colormap(depth, 1.0, 3.0), jr.depth_colormap(depth, 1.0, 3.0))
    assert np.array_equal(tr.flow_to_rgb(flow), jr.flow_to_rgb(flow))
    assert np.array_equal(tr.flow_to_rgb(flow, 2.0), jr.flow_to_rgb(flow, 2.0))
    # without matplotlib: the 33-knot table, within 7 levels of matplotlib's
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *a, **k):
        if name.startswith("matplotlib"):
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    fallback = tr.depth_colormap(depth).astype(int)
    monkeypatch.setattr(builtins, "__import__", real_import)
    assert np.abs(fallback - jr.depth_colormap(depth).astype(int)).max() <= 7


def test_view_interpolation_matches_jax():
    from neural_jacobian_field_tpu.visualization import view_interpolation as jv
    from neural_jacobian_field_torch.visualization import view_interpolation as tv

    from _torch_port_common import look_at_offset

    a, b = look_at_offset(20.0).astype(np.float64), look_at_offset(-35.0).astype(np.float64)
    for t in (0.0, 0.3, 1.0):
        assert np.array_equal(tv.interpolate_pose(a, b, t), jv.interpolate_pose(a, b, t))
        assert tv.cosine_smooth(t) == jv.cosine_smooth(t)
    assert np.array_equal(tv.generate_wobble(a[None], np.linspace(0, 1, 4)),
                          jv.generate_wobble(a[None], np.linspace(0, 1, 4)))
    rng = np.random.default_rng(3)
    steps, weights = rng.uniform(1, 3, (6, 8, 5)), rng.uniform(size=(6, 8, 5))
    k = np.array([[8.0, 0, 4], [0, 8.0, 3], [0, 0, 1]])
    assert np.array_equal(tv.reproj_best(steps, weights, a, b, k),
                          jv.reproj_best(steps, weights, a, b, k))


def test_validation_video_frames(scene):
    """Two frames at 48x64: uint8 videos; the first frame is the target
    camera's render (cosine easing starts at t = 0)."""
    from neural_jacobian_field_torch.data import collate, get_dataset
    from neural_jacobian_field_torch.config import CONFIG_DIR, get_typed_root_config, load_config
    from neural_jacobian_field_torch.inference.render import render_camera
    from neural_jacobian_field_torch.models.model import CameraInput, Model, RobotInput
    from neural_jacobian_field_torch.visualization import render_interpolated_view

    cfg = get_typed_root_config(load_config(CONFIG_DIR, [f"dataset.root={scene}", *E2E]))
    model = Model(cfg.model).init_weights(torch.Generator().manual_seed(0))
    raw = collate([get_dataset(cfg.dataset, "train")[4]])
    vids = render_interpolated_view(model, raw.ctxt_rgb, raw.ctxt_extrinsics, raw.ctxt_intrinsics,
                                    raw.trgt_extrinsics, raw.trgt_intrinsics, raw.robot_action,
                                    0.5, 10.0, num_frames=2, height=48, width=64)
    assert set(vids) == {"rgb", "depth", "optical_flow"}
    assert all(v.shape == (2, 48, 64, 3) and v.dtype == np.uint8 for v in vids.values())
    cam = CameraInput(raw.ctxt_rgb, raw.ctxt_extrinsics, raw.ctxt_intrinsics,
                      raw.trgt_extrinsics, raw.trgt_intrinsics)
    out = render_camera(model, cam, RobotInput(raw.robot_action), 0.5, 10.0, 48, 64)
    want = (np.clip(out.rgb[0].numpy(), 0, 1) * 255).astype(np.uint8)
    assert np.abs(vids["rgb"][0].astype(int) - want.astype(int)).max() <= 1


def test_profiling_helpers_on_cpu(tmp_path):
    """trace() writes a Chrome trace, span() names a range in it,
    device_idle_share reports no idle share for a CPU run (no device
    timeline)."""
    from neural_jacobian_field_torch.utils.profiling import device_idle_share, span, trace

    with trace(str(tmp_path)):
        with span("njf_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert "njf_span" in (tmp_path / "trace.json").read_text()
    out = device_idle_share(lambda: torch.ones(8).sum(), "cpu")
    assert out["busy_ms"] == 0.0 and out["idle_share"] is None and out["wall_ms"] > 0


def test_cli_run_json_reports_program_counters(stage1):
    """run.json's `program_counters`: each program's captures, replays,
    composites, per-sample pyramid lookups and fused transformer points at
    the end of the run (the train programs of a concat-layout encoder make
    no lookups: one map, no pyramid; its Jacobian MLP runs no transformer)."""
    out, state = stage1
    run = json.loads((out / "logs" / "run.json").read_text())
    trains = [c for k, c in run["program_counters"].items() if k.startswith("train")]
    assert trains and all(set(c) == {"captures", "replays", "composites", "pixel_gathers",
                                     "attn_fused_points"} for c in trains)
    assert all(c["pixel_gathers"] == 0 and c["attn_fused_points"] == 0 and c["captures"] == 0
               for c in trains)
