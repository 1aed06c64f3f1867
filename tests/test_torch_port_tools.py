"""The port's inference toolbox against the JAX package, on the CPU.

- compositing (`composite`, `render_depth`): float32 reductions on both
  sides, 1e-6 of scale (summation order only);
- the joint-sensitivity maps: the port keeps a copy of JAX's NumPy code, so
  bit for bit on seeded arrays (and on a torch tensor); on a small render of
  the same bridged weights (tests/_torch_port_common.py's model) the maps
  agree to 2e-2 (the renders' Jacobian features agree to the field
  tolerance, 5e-3 of scale, and the per-joint min-max normalisation
  divides by each joint's range, which magnifies that by up to ~4x);
- `parse_camera_json` in its three json forms, exactly;
- `load_model`: a checkpoint written by the port's CheckpointManager comes
  back bit for bit; `resolve_checkpoint`; the device rule;
- the overlays (cv2), bit for bit;
- `port_reference_checkpoint` against JAX's `port_reference_checkpoint`
  followed by the weight bridge, key for key and bit for bit, batch
  statistics included, for the Jacobian-MLP and the transformer decoders;
- the ingest CLI (`python -m neural_jacobian_field_torch.ingest`) on
  fabricated RAFT and reference checkpoints: its report's counts equal
  those of JAX's library functions on the same files.
"""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import randomize_variables, scene_arrays, jax_model_cfg, torch_model_cfg
from neural_jacobian_field_torch.utils.from_jax import from_jax_variables


def _close(got, want, tol):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err <= tol, f"max err {err:.3e} > {tol:.1e}"


# ---------------------------------------------------------------- compositing

@pytest.mark.parametrize("bg", [None, 0.5, "per_channel"])
def test_composite_matches_jax(bg):
    from neural_jacobian_field_tpu.ops import compositing as jc
    from neural_jacobian_field_torch.ops import composite

    rng = np.random.default_rng(0)
    w = rng.uniform(0, 0.1, (3, 5, 16, 1)).astype(np.float32)
    v = rng.normal(size=(3, 5, 16, 4)).astype(np.float32)
    bgv = rng.uniform(size=(4,)).astype(np.float32) if bg == "per_channel" else bg
    want = jc.composite(jnp.asarray(w), jnp.asarray(v),
                        None if bgv is None else jnp.asarray(bgv))
    got = composite(torch.from_numpy(w), torch.from_numpy(v),
                    None if bgv is None else torch.as_tensor(bgv))
    _close(got, want, 1e-6)


def test_render_depth_matches_jax():
    from neural_jacobian_field_tpu.ops import compositing as jc
    from neural_jacobian_field_torch.ops import render_depth, render_weights

    rng = np.random.default_rng(1)
    steps = np.sort(rng.uniform(0.5, 4.0, (2, 7, 24, 1)), axis=-2).astype(np.float32)
    dens = rng.uniform(0, 3, (2, 7, 24, 1)).astype(np.float32)
    deltas = np.diff(steps, axis=-2, append=steps[..., -1:, :] + 0.1)
    w = render_weights(torch.from_numpy(dens), torch.from_numpy(deltas))
    jw = jc.render_weights(jnp.asarray(dens), jnp.asarray(deltas))
    _close(w, jw, 1e-6)
    # zero weights on a ray: the clip holds it inside the steps' range
    w[0, 0] = 0.0
    jw = jw.at[0, 0].set(0.0)
    _close(render_depth(w, torch.from_numpy(steps)), jc.render_depth(jw, jnp.asarray(steps)),
           1e-6)


# --------------------------------------------------------------- sensitivity

def _sens_inputs():
    rng = np.random.default_rng(2)
    j = rng.normal(size=(2, 9, 11, 8 * 3)).astype(np.float32)
    ext = rng.normal(size=(2, 4, 4)).astype(np.float32)
    return j, ext


@pytest.mark.parametrize("case", ["plain", "extrinsics", "mode1", "tensor"])
def test_joint_sensitivity_bit_for_bit(case):
    from neural_jacobian_field_tpu.inference import sensitivity as js
    from neural_jacobian_field_torch.inference import sensitivity as ts

    j, ext = _sens_inputs()
    kw = {"extrinsics": ext} if case == "extrinsics" else {}
    if case == "mode1":
        kw["mode"] = 1
    want = js.compute_joint_sensitivity(j, **kw)
    arg = torch.from_numpy(j) if case == "tensor" else j
    got = ts.compute_joint_sensitivity(arg, **kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    palette = np.asarray(ts.JACOBIAN_COLORMAP["model_allegro"]).T
    assert ts.JACOBIAN_COLORMAP == js.JACOBIAN_COLORMAP
    img = ts.visualize_joint_sensitivity(got, palette)
    assert img.shape == (2, 9, 11, 3) and img.dtype == np.uint8
    assert np.array_equal(img, js.visualize_joint_sensitivity(want, palette))


def test_point_cloud_and_chain_structure_bit_for_bit():
    from neural_jacobian_field_tpu.inference import sensitivity as js
    from neural_jacobian_field_torch.inference import sensitivity as ts

    rng = np.random.default_rng(3)
    pts = rng.normal(size=(50, 6, 3)).astype(np.float32)
    assert np.array_equal(ts.compute_joint_sensitivity_point_cloud(pts),
                          js.compute_joint_sensitivity_point_cloud(pts))
    image = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    sens = rng.uniform(size=(6, 12, 16)).astype(np.float32)
    colors = np.asarray(ts.JACOBIAN_COLORMAP["model_toy_arm"], np.float32)
    for got, want in zip(ts.visualize_jacobian_chain_structure(image, sens, colors),
                         js.visualize_jacobian_chain_structure(image, sens, colors)):
        assert got.shape == (24, 32, 4) and np.array_equal(got, want)


def test_sensitivity_of_a_render_matches_jax():
    """A 6x8 render of the small model from the same bridged weights on
    both sides, then each package's sensitivity of its own render."""
    from neural_jacobian_field_tpu.inference.render import render_camera as j_render
    from neural_jacobian_field_tpu.inference.sensitivity import compute_joint_sensitivity as js
    from neural_jacobian_field_tpu.models import model as jm
    from neural_jacobian_field_torch.inference import compute_joint_sensitivity
    from neural_jacobian_field_torch.inference.render import render_camera
    from neural_jacobian_field_torch.models.model import CameraInput, Model, RobotInput

    a = scene_arrays()
    jcam = jm.CameraInput(*(jnp.asarray(a[k]) for k in ("image", "ctxt", "intr", "trgt",
                                                          "intr")))
    jrobot = jm.RobotInput(robot_action=jnp.asarray(a["action"]))
    jri = jm.RenderingInput(origins=jnp.asarray(a["origins"]), directions=jnp.asarray(a["dirs"]),
                            z_near=jnp.asarray(a["near"]), z_far=jnp.asarray(a["far"]))
    ctx = jm.StepCtx(key=jax.random.PRNGKey(0), anneal=jnp.asarray(1.0),
                     updated=jnp.asarray(True))
    jmodel = jm.Model(cfg=jax_model_cfg())
    variables = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                               jm.ModelInput(jcam, jri, jrobot), ctx)
    variables = randomize_variables(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                                 dict(variables)))
    want = j_render(jmodel, variables, jcam, jrobot, 0.5, 4.0, height=6, width=8,
                    patch_size=16)
    tmodel = Model(torch_model_cfg())
    tmodel.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"]),
                           strict=True)
    tmodel.eval()
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    got = render_camera(tmodel, CameraInput(t["image"], t["ctxt"], t["intr"], t["trgt"],
                                            t["intr"]),
                        RobotInput(robot_action=t["action"]), 0.5, 4.0, height=6, width=8,
                        patch_size=16)
    s_got = compute_joint_sensitivity(got.action_features)
    s_want = js(np.asarray(want.action_features))
    assert s_got.shape == (1, 4, 6, 8)
    _close(s_got, s_want, 2e-2)


# ------------------------------------------------------------------- loaders

CAMERA_FORMS = {
    "transform_fl": {"transform_matrix": np.eye(4).tolist(), "h": 48, "w": 64,
                     "fl_x": 50.0, "fl_y": 52.0, "cx": 31.0, "cy": 25.0},
    "camera_to_world_fov": {"camera_to_world": np.arange(16.0).tolist(), "height": 60,
                            "width": 80, "fov": 50.0},
    "camera_path": {"camera_path": [{"camera_to_world": (np.eye(4) * 2).ravel().tolist(),
                                     "h": 40, "w": 40, "fov": 70.0}]},
}


@pytest.mark.parametrize("form", sorted(CAMERA_FORMS))
@pytest.mark.parametrize("downscale", [1.0, 2.0])
def test_parse_camera_json_matches_jax(form, downscale, tmp_path):
    from neural_jacobian_field_tpu.inference.loaders import parse_camera_json as jp
    from neural_jacobian_field_torch.inference import parse_camera_json

    path = tmp_path / "camera.json"
    path.write_text(json.dumps(CAMERA_FORMS[form]))
    got, want = parse_camera_json(path, downscale), jp(path, downscale)
    assert got.keys() == want.keys()
    for k in got:
        assert np.array_equal(got[k], want[k]), k
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


TINY = ["model.action_dim=4", "model.rendering.num_proposal_samples=[8]",
        "model.rendering.num_nerf_samples=8", "model.encoder.num_layers=2",
        "model.encoder.norm_type=batch"]


def test_load_model_round_trip(tmp_path):
    """A model trained for no step but with seeded, then perturbed, weights
    and running statistics, saved by the port's CheckpointManager, comes back
    through load_model bit for bit, in eval mode."""
    from neural_jacobian_field_torch.config import CONFIG_DIR, get_typed_root_config, load_config
    from neural_jacobian_field_torch.inference import load_model
    from neural_jacobian_field_torch.models.model import Model
    from neural_jacobian_field_torch.training import TrainCfg, create_train_state
    from neural_jacobian_field_torch.training.checkpoint import CheckpointManager

    cfg = get_typed_root_config(load_config(CONFIG_DIR, TINY))
    model = Model(cfg.model).init_weights(torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            t.add_(0.1 * torch.randn(t.shape, generator=g).abs())
    state = create_train_state(model, TrainCfg())
    assert CheckpointManager(tmp_path / "ck", save_interval_steps=1).maybe_save(state)

    loaded = load_model(CONFIG_DIR, tmp_path / "ck", TINY, device="cpu")
    assert not loaded.training
    want, got = model.state_dict(), loaded.state_dict()
    assert got.keys() == want.keys()
    assert any(k.endswith("running_mean") for k in got)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # without a checkpoint: the config's seed
    fresh = load_model(CONFIG_DIR, None, TINY, device="cpu")
    seeded = Model(cfg.model).init_weights(torch.Generator().manual_seed(cfg.seed))
    assert all(torch.equal(v, seeded.state_dict()[k]) for k, v in fresh.state_dict().items())


def test_load_model_raises_without_a_card(monkeypatch):
    from neural_jacobian_field_torch.config import CONFIG_DIR
    from neural_jacobian_field_torch.inference import load_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(CONFIG_DIR, None, TINY)


def test_resolve_checkpoint(tmp_path):
    from neural_jacobian_field_torch.inference import resolve_checkpoint

    assert resolve_checkpoint(tmp_path / "ck") == str(tmp_path / "ck")
    assert resolve_checkpoint("checkpoints/run") == "checkpoints/run"
    with pytest.raises(RuntimeError, match="wandb"):
        resolve_checkpoint("wandb://entity/project/run:v3")


# ------------------------------------------------------------------ overlays

def _images():
    rng = np.random.default_rng(4)
    return (rng.uniform(size=(40, 56, 3)).astype(np.float32),
            rng.integers(0, 256, (36, 48, 3), dtype=np.uint8), rng)


def test_draw_pixel_motion_bit_for_bit():
    pytest.importorskip("cv2")
    from neural_jacobian_field_tpu.visualization import validation as jv
    from neural_jacobian_field_torch.visualization import draw_pixel_motion

    img, img8, rng = _images()
    yx = rng.uniform(0, 39, (30, 2))
    motion = rng.normal(scale=6.0, size=(30, 2))
    visible = rng.uniform(size=30) > 0.3
    for image, kw in ((img, {}), (img8, {"visible": visible, "color": (255, 0, 0),
                                         "thickness": 2})):
        # a uint8 image is drawn on in place, by both
        got = draw_pixel_motion(image.copy(), yx, motion, **kw)
        want = jv.draw_pixel_motion(image.copy(), yx, motion, **kw)
        assert got.dtype == np.uint8 and got.shape == image.shape
        assert np.array_equal(got, want)
        assert (got != (image if image.dtype == np.uint8 else
                        (np.clip(image, 0, 1) * 255).astype(np.uint8))).any()


def test_ping_pong_and_point_matches_bit_for_bit():
    pytest.importorskip("cv2")
    from neural_jacobian_field_tpu.visualization import validation as jv
    from neural_jacobian_field_torch.visualization import draw_point_matches, ping_pong

    img, img8, rng = _images()
    video = rng.integers(0, 256, (5, 8, 8, 3), dtype=np.uint8)
    assert np.array_equal(ping_pong(video), jv.ping_pong(video))
    pa = rng.uniform(0, 40, (12, 2))
    pb = rng.uniform(0, 36, (12, 2))
    got = draw_point_matches(img, img8, pa, pb, radius=3)
    want = jv.draw_point_matches(img, img8, pa, pb, radius=3)
    assert got.shape == (40, 56 + 48, 3) and np.array_equal(got, want)


# ------------------------------------------------- reference checkpoints

def _transformer_reference_name(key: str) -> str:
    """The transformer decoder's own entries -> the reference's names: its
    plain Linear head decoder.jacobian_head.<leaf> keeps its name, and
    decoder.jacobian_attn_decoder.layers_<i>_<part>[.<sub>].<leaf> goes to
    the PreNorm-wrapped layers (model_components/transformer.py: layers.i.0
    = PreNorm(Attention), layers.i.1 = PreNorm(FeedForward))."""
    mods = key.split(".")
    if mods[1] == "jacobian_head":
        return f"model.{key}"
    _, i, part = mods[2].split("_", 2)
    sub = {"attn_norm": "0.norm", "ff_norm": "1.norm"}.get(part)
    if sub is None and part == "attn":
        sub = "0.fn." + {"to_out": "to_out.0"}.get(mods[3], mods[3])
    elif sub is None:  # ff: net = Sequential(Linear, GELU, Dropout, Linear, Dropout)
        sub = "1.fn.net." + {"fc1": "0", "fc2": "3"}[mods[3]]
    return f"model.decoder.jacobian_attn_decoder.layers.{i}.{sub}.{mods[-1]}"


def fabricate_reference(model: torch.nn.Module, seed: int = 0) -> dict:
    """A reference-named numpy state dict of `model`'s structure with seeded
    values: the seeded state as the Flax tree that the bridge maps onto it,
    named by the JAX tests' reference naming (tests/test_port.py), which
    leaves out the transformer decoder's head and attention layers; those
    are named here."""
    import flax.traverse_util as tu

    from tests.test_port import fabricate_state_dict

    rng = np.random.default_rng(seed)
    state, params, stats, own = {}, {}, {}, {}
    for key, t in model.state_dict().items():
        v = (rng.uniform(0.5, 1.5, tuple(t.shape)) if key.endswith("running_var")
             else rng.normal(scale=0.05, size=tuple(t.shape))).astype(np.float32)
        state[key] = torch.from_numpy(v)
        *mods, leaf = key.split(".")
        path = "/".join(mods)
        if key.startswith("decoder.jacobian_attn_decoder.") or (
                path == "decoder/jacobian_head"):  # the transformer's Linear head
            own[key] = v
        elif leaf in ("running_mean", "running_var"):
            stats[f"{path}/{leaf.split('_')[1]}"] = v
        elif leaf == "weight":
            params[f"{path}/{'scale' if v.ndim == 1 else 'kernel'}"] = v.T if v.ndim == 2 else v
        elif leaf == "bias":
            params[f"{path}/bias"] = v
        else:  # a bare parameter
            params["/".join(key.split("."))] = v
    # the Flax tree is the seeded state's, apart from the entries named here
    bridged = from_jax_variables(tu.unflatten_dict(params, sep="/"),
                                 tu.unflatten_dict(stats, sep="/"))
    assert sorted(bridged) == sorted(k for k in state if k not in own)
    assert all(torch.equal(bridged[k], state[k]) for k in bridged)
    return {**fabricate_state_dict(params, stats),
            **{_transformer_reference_name(k): v for k, v in own.items()}}


def _reference_model(decoder):
    from neural_jacobian_field_torch.models.encoder_resnet import EncoderResnetCfg
    from neural_jacobian_field_torch.models.model import Model, RenderingCfg, make_model_cfg

    return Model(make_model_cfg(decoder, action_dim=8,
                                rendering=RenderingCfg(pixel_feature_mode="exact"),
                                encoder=EncoderResnetCfg(norm_type="batch",
                                                         feature_layout="concat")))


@pytest.mark.parametrize("decoder", ["jacobian_mlp", "jacobian_transformer"])
def test_port_reference_checkpoint_matches_jax_route(decoder):
    """The port's map against JAX's port_reference_checkpoint followed by
    from_jax_variables: the same keys, the same bits; and it loads into the
    port's model of that structure with strict=True."""
    import flax.traverse_util as tu

    from neural_jacobian_field_tpu.utils.port_torch import port_reference_checkpoint as jport
    from neural_jacobian_field_torch.utils.port_torch import is_stat, port_reference_checkpoint

    model = _reference_model(decoder)
    sd = fabricate_reference(model)
    got = port_reference_checkpoint(sd)
    params, stats = jport(sd)
    want = from_jax_variables(tu.unflatten_dict(params, sep="/"),
                              tu.unflatten_dict(stats, sep="/"))
    assert sorted(got) == sorted(want)
    assert sum(map(is_stat, got)) == len(stats) > 0
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    model.load_state_dict(got, strict=True)
    assert sorted(got) == sorted(model.state_dict())


def test_load_reference_checkpoint_file(tmp_path):
    """A Lightning-style file ({"state_dict": ...} with torch tensors and
    other objects) loads into the model in place; an entry of another shape
    is skipped and counted."""
    from neural_jacobian_field_torch.utils.port_torch import load_reference_checkpoint

    model = _reference_model("jacobian_mlp")
    sd = fabricate_reference(model, seed=1)
    sd["model.decoder.color_head.4.weight"] = np.zeros((5, 5), np.float32)
    path = tmp_path / "epoch=9.ckpt"
    # a Lightning checkpoint also pickles objects weights_only refuses
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()},
                "epoch": 9, "hyper_parameters": argparse.Namespace(lr=1e-4)}, path)
    matched, skipped = load_reference_checkpoint(path, model)
    assert matched == sum(1 for _ in model.parameters()) - 1
    assert skipped == ["decoder.color_head.fc3.weight"]
    w = sd["model.encoder.model.layer1.0.conv1.weight"].transpose(2, 3, 1, 0)
    assert torch.equal(model.encoder.layer1_block0.conv1.weight, torch.from_numpy(w))


# ---------------------------------------------------------------- ingest CLI

def test_ingest_raft_counts_match_jax(tmp_path, capsys):
    from test_pretrained_ports import fabricate_raft_state_dict

    from neural_jacobian_field_tpu.flow import RAFT as JRAFT
    from neural_jacobian_field_tpu.flow.raft import load_torch_raft_state_dict as jload
    from neural_jacobian_field_torch import ingest

    sd = fabricate_raft_state_dict()
    path = tmp_path / "raft-things.pth"
    torch.save({k: torch.from_numpy(np.asarray(v).copy()) for k, v in sd.items()}, path)
    out = tmp_path / "raft.pt"
    assert ingest.main([str(path), "--out", str(out), "--device", "cpu", "--eval",
                        "--raft-iters", "2"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["eval"]["finite"] and len(report["eval"]["median_flow_px"]) == 2

    x = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(JRAFT(num_iters=1).init, jax.random.PRNGKey(0), x, x)["params"]
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    unused = []
    params = jload(template, sd, unused_out=unused)
    assert report["kind"] == "raft"
    assert (report["consumed"], report["unused"]) == (len(sd) - len(unused), len(unused))
    assert report["unused"] == 0
    n_leaves = len(jax.tree.leaves(params))
    assert report["overwritten"] == report["total_leaves"] == n_leaves
    saved = torch.load(out, weights_only=True)
    want = from_jax_variables(params)
    assert sorted(saved) == sorted(want)
    assert all(torch.equal(saved[k], want[k]) for k in want)


def test_ingest_reference_counts_match_jax(tmp_path, capsys):
    import flax.traverse_util as tu

    from neural_jacobian_field_tpu.utils.port_torch import port_reference_checkpoint as jport
    from neural_jacobian_field_torch import ingest

    model = _reference_model("jacobian_mlp")
    sd = fabricate_reference(model, seed=2)
    sd["model.decoder.not_a_module.weight"] = np.zeros(3, np.float32)  # ignored by both
    path = tmp_path / "epoch=99.ckpt"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    out = tmp_path / "ref.pt"
    assert ingest.main([str(path), "--out", str(out), "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    # JAX's CLI counts the mapped params that its template (the same model,
    # initialised by create_train_state) has with a matching shape
    import sys
    from pathlib import Path

    from neural_jacobian_field_tpu.models.encoder_resnet import EncoderResnetCfg
    from neural_jacobian_field_tpu.models.model import Model, RenderingCfg, make_model_cfg
    from neural_jacobian_field_tpu.training import TrainCfg, create_train_state

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import bench

    jmodel = Model(cfg=make_model_cfg(
        "jacobian_mlp", action_dim=8, rendering=RenderingCfg(pixel_feature_mode="exact"),
        encoder=EncoderResnetCfg(norm_type="batch", feature_layout="concat")))
    raw = bench._raw_batch(jax.random.PRNGKey(0), batch=1, hw=(64, 64))
    tstate = jax.eval_shape(lambda k: create_train_state(
        k, jmodel, raw, TrainCfg(mode="perception", rays_per_batch=32)), jax.random.PRNGKey(0))
    tmpl = tu.flatten_dict(tstate.params, sep="/")
    # the JAX tests' own reference naming (tests/test_port.py) of that
    # template names the same tensors as the port model's fabricated file
    from tests.test_port import fabricate_state_dict

    zeros = lambda tree: {k: np.zeros(v.shape, np.float32)
                          for k, v in tu.flatten_dict(tree, sep="/").items()}
    assert sorted(fabricate_state_dict(zeros(tstate.params), zeros(tstate.batch_stats))) == \
        sorted(k for k in sd if "not_a_module" not in k)
    params, _ = jport(sd)
    matched = sum(1 for k, v in params.items() if k in tmpl and tmpl[k].shape == v.shape)
    assert report["kind"] == "reference"
    assert (report["consumed"], report["unused"]) == (matched, len(params) - matched)
    assert report["total_leaves"] == len(tmpl) == matched
    saved = torch.load(out, weights_only=True)
    w = sd["model.decoder.density_head.lin_in.weight"]
    assert torch.equal(saved["decoder.density_head.lin_in.weight"], torch.from_numpy(w))


def test_ingest_dinov2_waits_for_the_2d_slice(tmp_path, capsys):
    """The dinov2 kind came with the 2D family (tests/test_torch_port_jacobian2d.py
    ingests a whole ViT-S/14): a state dict with the kind's keys but not
    the ViT's tensors is refused, and nothing is written."""
    from neural_jacobian_field_torch import ingest

    path = tmp_path / "dinov2.pth"
    torch.save({"patch_embed.proj.weight": torch.zeros(2, 3), "cls_token": torch.zeros(1)},
               path)
    with pytest.raises(KeyError):
        ingest.main([str(path), "--device", "cpu"])
    assert not (tmp_path / "dinov2.pth.torch.pt").exists()
