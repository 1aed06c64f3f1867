"""The port's other action decoders, the arm heads, make_model_cfg and remat
against the JAX package, in float32 on the CPU.

The small flagship-shaped model of tests/_torch_port_common.py with its
Jacobian-MLP decoder swapped for the transformer decoder (dim 16, 2 heads of
8, depth 2, MLP 16), the flow-MLP decoder, or an arm model (arm_action_dim
3); seeded random weights through the bridge; the same numpy inputs. Field
outputs are held at test_torch_port_model.py's FIELD_TOL (5e-3 of scale:
the top NeRF frequency turns float32 rounding of a sample position into
~1e-3 of its encoding).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import (
    ACTION_DIM, MLP, jax_model_cfg, randomize_variables, scene_arrays, torch_model_cfg)
from neural_jacobian_field_torch.utils.from_jax import from_jax_variables

FIELD_TOL = 5e-3
TRANSFORMER = dict(attn_feat_dim=16, attn_head_dim=8, num_attn_heads=2, attn_depth=2,
                   attn_mlp_dim=16)
ARM_DIM = 3
DECODER_NAMES = ("jacobian_mlp", "jacobian_transformer", "flow_mlp")


def _close(got, want, tol=FIELD_TOL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err <= tol, f"max err {err:.3e} > {tol:.1e}"


def _close_flow(got, want, warped, trgt):
    """Optical flow away from the target camera's plane: the random field
    moves composited points by metres, and one that lands within 0.05 of
    that plane (camera z of `warped`, the world position the flow projects)
    turns the field tolerance into a flow error without bound, so the flow
    is compared on the rays outside that band (at least 3/4 of them); the
    warped positions themselves are compared everywhere by the callers."""
    w = np.asarray(warped)
    z = ((w - trgt[:, None, :3, 3]) @ trgt[:, :3, :3])[..., 2]
    ok = np.abs(z) >= 0.05
    assert ok.mean() >= 0.75
    g = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    _close(g[ok], np.asarray(want)[ok])


def _decoder_cfgs(name, arm=False, mode="epipolar"):
    """(JAX ModelCfg, port ModelCfg) of the small model with this decoder."""
    from neural_jacobian_field_tpu.models import decoders as jd
    from neural_jacobian_field_tpu.models.resnet_fc import MlpCfg as JMlp
    from neural_jacobian_field_torch.models import decoders as td
    from neural_jacobian_field_torch.models.resnet_fc import MlpCfg

    extra = dict(use_arm_model=True, arm_action_dim=ARM_DIM) if arm else {}
    cfgs = []
    for dec, mlp, base in ((jd, JMlp, jax_model_cfg()), (td, MlpCfg, torch_model_cfg())):
        kw = dict(mlp=mlp(**MLP), **extra)
        if name == "jacobian_transformer":
            kw["transformer"] = dec.TransformerCfg(**TRANSFORMER)
        cls = dec.DECODERS[name][0]
        cfgs.append(dataclasses.replace(
            base, action_decoder=cls(**kw),
            rendering=dataclasses.replace(base.rendering, pixel_feature_mode=mode)))
    return cfgs


def _inputs(jm, tm, a, action=None):
    action = a["action"] if action is None else action
    jcam = jm.CameraInput(input_image=jnp.asarray(a["image"]),
                          ctxt_extrinsics=jnp.asarray(a["ctxt"]),
                          ctxt_intrinsics=jnp.asarray(a["intr"]),
                          trgt_extrinsics=jnp.asarray(a["trgt"]),
                          trgt_intrinsics=jnp.asarray(a["intr"]))
    jri = jm.RenderingInput(origins=jnp.asarray(a["origins"]), directions=jnp.asarray(a["dirs"]),
                            z_near=jnp.asarray(a["near"]), z_far=jnp.asarray(a["far"]))
    jmi = jm.ModelInput(camera_input=jcam, rendering_input=jri,
                        robot_input=jm.RobotInput(robot_action=jnp.asarray(action)))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    tcam = tm.CameraInput(input_image=t["image"], ctxt_extrinsics=t["ctxt"],
                          ctxt_intrinsics=t["intr"], trgt_extrinsics=t["trgt"],
                          trgt_intrinsics=t["intr"])
    tri = tm.RenderingInput(origins=t["origins"], directions=t["dirs"], z_near=t["near"],
                            z_far=t["far"])
    tmi = tm.ModelInput(tcam, tri, tm.RobotInput(robot_action=torch.from_numpy(action)))
    return jmi, tmi


def _build(name, arm=False, mode="epipolar", remat=False):
    """The JAX model, its randomised variables, the port model loaded with
    them, and the inputs of both."""
    from neural_jacobian_field_tpu.models import model as jm
    from neural_jacobian_field_torch.models import model as tm

    jcfg, tcfg = _decoder_cfgs(name, arm, mode)
    a = scene_arrays()
    jmi, tmi = _inputs(jm, tm, a)
    ctx = jm.StepCtx(key=jax.random.PRNGKey(0), anneal=jnp.asarray(1.0),
                     updated=jnp.asarray(True))
    jmodel = jm.Model(cfg=jcfg, remat=remat)
    variables = randomize_variables(jax.tree.map(np.asarray, dict(
        jmodel.init(jax.random.PRNGKey(0), jmi, ctx))))
    tmodel = tm.Model(tcfg, remat=remat)
    tmodel.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"]),
                           strict=True)
    return dict(jm=jm, tm=tm, jmodel=jmodel, variables=variables, tmodel=tmodel.eval(),
                jmi=jmi, tmi=tmi, ctx=ctx, arrays=a)


@pytest.mark.parametrize("name", ["jacobian_transformer", "flow_mlp"])
def test_model_forward_matches_jax(name):
    """The whole eval forward with the visualisation features: rgb, depth,
    flow and the composited action features (the Jacobian, or the flow
    head's block outputs, 2 x 32 wide); the flow is not trivially zero."""
    s = _build(name)
    want = s["jmodel"].apply(s["variables"], s["jmi"], s["ctx"], train=False,
                             compute_vis_features=True)
    with torch.no_grad():
        got = s["tmodel"](s["tmi"], compute_vis_features=True)
    _close(got.rgb, want.rgb)
    _close(got.depth, want.depth)
    _close(got.ray_positions_warped, want.ray_positions_warped)
    _close_flow(got.optical_flow, want.optical_flow, want.ray_positions_warped,
                s["arrays"]["trgt"])
    _close(got.action_features, want.action_features)
    assert np.abs(np.asarray(want.optical_flow)).max() > 1e-3
    width = MLP["n_blocks"] * MLP["d_hidden"] if name == "flow_mlp" else 3 * ACTION_DIM
    assert got.action_features.shape[-1] == width
    # without the features the flow is the same, and none are computed
    with torch.no_grad():
        plain = s["tmodel"](s["tmi"])
    assert plain.action_features is None and torch.equal(plain.optical_flow,
                                                         got.optical_flow)


def test_transformer_jacobian_encode_image_matches_jax():
    """encode_image: the density and the transformer decoder's Jacobian at
    every sample (its compute_jacobian), then the flow of an action through
    infer_optical_flow."""
    from neural_jacobian_field_tpu.models.model import Model as JModel

    s = _build("jacobian_transformer")
    jenc = s["jmodel"].apply(s["variables"], s["jmi"].camera_input, s["jmi"].rendering_input,
                             s["jmi"].robot_input, s["ctx"], method=JModel.encode_image)
    tenc = s["tmodel"].encode_image(s["tmi"].camera_input, s["tmi"].rendering_input,
                                    s["tmi"].robot_input)
    _close(tenc.density, jenc.density)
    _close(tenc.action_features, jenc.action_features)
    assert tenc.action_features.shape[-1] == 3 * ACTION_DIM
    want = s["jmodel"].apply(s["variables"], jenc, s["jmi"].camera_input, s["jmi"].robot_input,
                             method=JModel.infer_optical_flow)
    # the composited warped positions the flow projects (JAX's encoding)
    j = np.asarray(jenc.action_features).reshape(*jenc.action_features.shape[:-1], ACTION_DIM, 3)
    pos = np.asarray(jenc.ray_samples_positions)
    moved = pos + np.einsum("brsat,ba->brst", j, s["arrays"]["action"])
    warped = np.sum(np.asarray(jenc.weights) * moved, axis=-2)
    _close_flow(s["tmodel"].infer_optical_flow(tenc, s["tmi"].camera_input,
                                               s["tmi"].robot_input), want, warped,
                s["arrays"]["trgt"])


def test_flow_mlp_has_no_inverse_dynamics_encoding():
    """flow_mlp's encode_image raises JAX's NotImplementedError, and so the
    port's inverse-dynamics entry point refuses it."""
    s = _build("flow_mlp")
    with pytest.raises(NotImplementedError, match="flow is nonlinear in the action"):
        s["tmodel"].encode_image(s["tmi"].camera_input, s["tmi"].rendering_input,
                                 s["tmi"].robot_input)
    with pytest.raises(NotImplementedError, match="no Jacobian"):
        s["tmodel"].decoder.compute_jacobian(None)


@pytest.mark.parametrize("name", DECODER_NAMES)
def test_arm_heads_match_jax(name):
    """With use_arm_model: the arm head's flow (and Jacobian or features)
    for an arm action of arm_action_dim, through the decoder's
    forward(..., arm=True), in exact mode; the main head is unchanged by the
    arm head's presence."""
    s = _build(name, arm=True, mode="exact")
    jm, tm = s["jm"], s["tm"]
    rng = np.random.default_rng(5)
    arm_action = rng.normal(size=(1, ARM_DIM)).astype(np.float32)
    xyz = rng.uniform(-0.4, 0.4, size=(1, 6, 4, 3)).astype(np.float32)
    xyz[..., 2] += 2.0
    dirs = rng.normal(size=(1, 6, 4, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    jmi, tmi = _inputs(jm, tm, s["arrays"], action=arm_action)

    def arm_call(m, cam, robot, x, d):
        out = m.decoder(x, d, m.compute_pixel_encoding(cam, robot), arm=True)
        return out.flow, out.action_features

    wflow, wfeat = s["jmodel"].apply(s["variables"], jmi.camera_input, jmi.robot_input,
                                     jnp.asarray(xyz), jnp.asarray(dirs), method=arm_call)
    model = s["tmodel"]
    with torch.no_grad():
        pe = model.compute_pixel_encoding(tmi.camera_input, tmi.robot_input)
        out = model.decoder(torch.from_numpy(xyz), torch.from_numpy(dirs), pe, arm=True)
    _close(out.flow, wflow)
    _close(out.action_features, wfeat)
    head = "flow_head_arm" if name == "flow_mlp" else "jacobian_head_arm"
    assert hasattr(model.decoder, head)
    assert not getattr(model.decoder, head).fused_trunk
    assert not getattr(model.decoder, head).remat


def _plain(x):
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, {f.name: _plain(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


@pytest.mark.parametrize("name", DECODER_NAMES)
def test_make_model_cfg_matches_jax(name):
    """make_model_cfg(name) field by field as JAX's; its model's parameter
    tree (names and shapes, the JAX defaults' group-norm encoder included)
    is the JAX Model's through the bridge; ModelCfg() is make_model_cfg()."""
    from neural_jacobian_field_tpu.models import model as jm
    from neural_jacobian_field_torch.models import model as tm

    assert _plain(tm.make_model_cfg(name)) == _plain(jm.make_model_cfg(name))
    assert _plain(tm.make_model_cfg(name, action_dim=4)) == _plain(
        jm.make_model_cfg(name, action_dim=4))
    assert tm.ModelCfg() == tm.make_model_cfg()
    a = scene_arrays()
    jmi, _ = _inputs(jm, tm, a, action=np.zeros((1, 8), np.float32))
    ctx = jm.StepCtx(key=jax.random.PRNGKey(0), anneal=jnp.asarray(1.0),
                     updated=jnp.asarray(True))
    shapes = jax.eval_shape(jm.Model(cfg=jm.make_model_cfg(name)).init,
                            jax.random.PRNGKey(0), jmi, ctx)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    want = from_jax_variables(zeros["params"], zeros.get("batch_stats"))
    model = tm.Model(tm.make_model_cfg(name))
    got = model.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    model.load_state_dict(want, strict=True)


def _loss_grads(model, tmi, c):
    model.zero_grad(set_to_none=True)
    out = model(tmi, compute_vis_features=True)
    loss = (out.rgb * c["rgb"]).sum() + (out.ray_positions_warped * c["warped"]).sum() \
        + (out.depth * c["depth"]).sum()
    loss.backward()
    return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("name", ["jacobian_mlp", "jacobian_transformer"])
def test_remat_matches_no_remat_and_jax(name):
    """remat=True recomputes the proposal, density and Jacobian-MLP trunks
    in the backward: in the port its forward and every parameter gradient
    equal remat=False's bit for bit; against JAX's Model(remat=True) the
    gradients agree to FIELD_TOL of scale per tensor. The loss reads rgb,
    depth and the warped positions (the Jacobian's output in 3D; the optical
    flow would add the projection's conditioning, _close_flow)."""
    from neural_jacobian_field_torch.models.resnet_fc import ResnetFC

    s = _build(name, remat=True)
    rng = np.random.default_rng(7)
    rays = s["arrays"]["origins"].shape[1]
    c = {k: rng.normal(size=(1, rays, d)).astype(np.float32)
         for k, d in (("rgb", 3), ("warped", 3), ("depth", 1))}
    tc = {k: torch.from_numpy(v) for k, v in c.items()}
    model = s["tmodel"]
    remat_trunks = [n for n, m in model.named_modules() if isinstance(m, ResnetFC) and m.remat]
    expect = ["decoder.density_head", "proposal_networks_0.density_head"]
    if name == "jacobian_mlp":
        expect.append("decoder.jacobian_head")
    assert sorted(remat_trunks) == sorted(expect)
    got = _loss_grads(model, s["tmi"], tc)
    plain = s["tm"].Model(model.cfg, remat=False)
    plain.load_state_dict(model.state_dict(), strict=True)
    plain.eval()
    want_port = _loss_grads(plain, s["tmi"], tc)
    assert set(got) == set(want_port)
    for k in got:
        assert torch.equal(got[k], want_port[k]), k

    def loss(params):
        out = s["jmodel"].apply({**s["variables"], "params": params}, s["jmi"], s["ctx"],
                                train=False, compute_vis_features=True)
        return (jnp.sum(out.rgb * c["rgb"]) + jnp.sum(out.ray_positions_warped * c["warped"])
                + jnp.sum(out.depth * c["depth"]))

    jgrads = jax.jit(jax.grad(loss))(jax.tree.map(jnp.asarray, s["variables"]["params"]))
    want = from_jax_variables(jax.tree.map(np.asarray, jgrads))
    checked = 0
    for k, g in got.items():
        if np.abs(want[k].numpy()).max() > 0:
            _close(g, want[k].numpy())
            checked += 1
    assert checked > 50


@pytest.mark.parametrize("name", ["jacobian_transformer", "flow_mlp"])
def test_steps_run_only_the_heads_a_loss_reads(name):
    """A stage-1 step renders no flow, so neither the transformer nor the flow
    head runs (the JAX jit drops them); a stage-2 step runs them, and the
    flow head's 640-wide block outputs are not built, since no loss reads
    them."""
    from unittest import mock

    from test_torch_port_action import _batch_arrays, _port_batch

    from neural_jacobian_field_torch.models.model import Model
    from neural_jacobian_field_torch.models.resnet_fc import ResnetFC
    from neural_jacobian_field_torch.models.transformer import Transformer
    from neural_jacobian_field_torch.training import TrainCfg, create_train_state, train_step

    _, tcfg = _decoder_cfgs(name)
    batch = _port_batch(_batch_arrays("flow"))
    for mode, runs in (("perception", False), ("action", True)):
        model = Model(tcfg).init_weights(torch.Generator().manual_seed(0))
        state = create_train_state(model, TrainCfg(mode=mode, rays_per_batch=16))
        calls = []
        heads = {"jacobian_transformer": (Transformer, "forward"),
                 "flow_mlp": (ResnetFC, "_forward")}
        cls, method = heads[name]
        orig = getattr(cls, method)

        def counted(self, *args, **kw):
            if name == "jacobian_transformer" or self is model.decoder.flow_head:
                calls.append(kw.get("compute_features", args[2] if len(args) > 2 else None))
            return orig(self, *args, **kw)

        with mock.patch.object(cls, method, counted):
            metrics = train_step(state, batch, torch.Generator().manual_seed(1))
        assert all(torch.isfinite(v) for v in metrics.values())
        assert bool(calls) == runs, (mode, calls)
        if name == "flow_mlp":
            assert not any(calls)  # compute_features never asked for
