"""The exact (reference-numerics) feature path of the port against the JAX
package: the coarse level's K1 gather and the pyramid sampling (forward and
backward), then the small flagship-shaped model of tests/_torch_port_common.py
in pixel_feature_mode="exact" — serving (forward, encode_image,
infer_optical_flow) and one stage-1 train step per proposal gate — run from
the same JAX params and batch statistics through utils/from_jax.py.

The JAX model runs on the CPU, where its kernels resolve to the XLA paths
(the one-hot gather's XLA form, the plain trunk); the port runs in float32 on
its plain chain, plus one bf16 case that goes through the fused trunk's and
K1's plain versions. Tolerances, as in test_torch_port_model.py and
test_torch_port_train_step.py: 1e-4 relative on geometry, 5e-3 of scale on
everything read from the field and on gradients (the top NeRF frequency,
2*pi*2^9, turns float32 rounding of a sample position into ~1e-3).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import (
    INTRINSICS, IMAGE_HW, jax_model_cfg, look_at_offset, randomize_variables, scene_arrays,
    torch_model_cfg)
from neural_jacobian_field_torch.models.model import (
    CameraInput, Model, ModelInput, RenderingInput, RobotInput)
from neural_jacobian_field_torch.utils.from_jax import from_jax_variables

FIELD_TOL = 5e-3
RAYS = 16
LR, WARMUP = 1e-4, 4


def _exact(cfg, **rendering):
    """The configuration in exact mode; the anneal exponent held at ~0, as
    the train-step test holds it (see test_torch_port_train_step.py)."""
    return replace(cfg, rendering=replace(cfg.rendering, pixel_feature_mode="exact",
                                          **rendering))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ------------------------------------------------------------ gathers

def _pyramids(seed=5, b=2, dtype="float32"):
    """A random pyramid (fine 16x24x128, mid 4x6x128, coarse 2x3x256, the
    test model's) on both sides, and fine-grid coordinates that also fall
    outside the image."""
    from neural_jacobian_field_tpu.ops.pixel_gather import FeaturePyramid as JPyr

    rng = np.random.default_rng(seed)
    shapes = ((16, 24, 128), (4, 6, 128), (2, 3, 256))
    levels = [rng.normal(size=(b, *s)).astype(np.float32) for s in shapes]
    fx = rng.uniform(-3, 26, size=(b, 200)).astype(np.float32)
    fy = rng.uniform(-3, 18, size=(b, 200)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jpyr = JPyr(*(jnp.asarray(v, jdt) for v in levels))
    tlevels = [torch.from_numpy(v).to(tdt).requires_grad_() for v in levels]
    return jpyr, tlevels, fx, fy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_bilinear_onehot_matches_jax(dtype):
    """Forward and the map's gradient against the JAX custom_vjp (its XLA
    one-hot form on the CPU): the same float32 products in another order,
    1e-5 of scale; the gradient comes back in the map's dtype (bf16: one
    rounding of the same float32 sum, 2^-8 of scale)."""
    from neural_jacobian_field_tpu.ops.pixel_gather import gather_bilinear_onehot as jgather
    from neural_jacobian_field_torch.ops.pixel_gather import gather_bilinear_onehot

    jpyr, tlevels, fx, fy = _pyramids(dtype=dtype)
    cx, cy = fx / 8.0, fy / 8.0
    g = np.random.default_rng(6).normal(size=(2, 200, 256)).astype(np.float32)
    out, vjp = jax.vjp(lambda lv: jgather(lv, jnp.asarray(cx), jnp.asarray(cy)), jpyr.coarse)
    (want_g,) = vjp(jnp.asarray(g))
    got = gather_bilinear_onehot(tlevels[2], torch.from_numpy(cx), torch.from_numpy(cy))
    assert got.dtype == torch.float32 and got.grad_fn is not None
    assert _rel(got.detach().numpy(), out) <= 1e-5
    got.backward(torch.from_numpy(g))
    assert tlevels[2].grad.dtype == tlevels[2].dtype
    tol = 1e-5 if dtype == "float32" else 2.0 ** -8
    assert _rel(tlevels[2].grad.float().numpy(), np.asarray(want_g, np.float32)) <= tol


def test_pyramid_pixel_features_match_jax():
    """All three levels sampled and concatenated in reference order, and the
    gradient of every level through the packing (K6), the packed-row gathers
    and K1, against jax.vjp of the JAX functions, float32: 1e-5 of scale."""
    from neural_jacobian_field_tpu.ops.pixel_gather import (
        pack_pyramid as jpack, pyramid_pixel_features as jfeatures)
    from neural_jacobian_field_torch.ops.pixel_gather import (
        FeaturePyramid, pack_pyramid, pyramid_pixel_features, pyramid_pixel_levels)

    jpyr, tlevels, fx, fy = _pyramids()
    g = np.random.default_rng(7).normal(size=(2, 200, 512)).astype(np.float32)
    out, vjp = jax.vjp(lambda p: jfeatures(jpack(p), jnp.asarray(fx), jnp.asarray(fy)), jpyr)
    (want,) = vjp(jnp.asarray(g))
    packed = pack_pyramid(FeaturePyramid(*tlevels))
    got = pyramid_pixel_features(packed, torch.from_numpy(fx), torch.from_numpy(fy))
    assert got.shape == (2, 200, 512) and got.dtype == torch.float32
    assert _rel(got.detach().numpy(), out) <= 1e-5
    levels = pyramid_pixel_levels(packed, torch.from_numpy(fx), torch.from_numpy(fy))
    assert [t.shape[-1] for t in levels] == [128, 128, 256]
    assert torch.equal(torch.cat(levels, dim=-1), got)
    got.backward(torch.from_numpy(g))
    for t, w in zip(tlevels, (want.fine, want.mid, want.coarse)):
        assert _rel(t.grad.numpy(), w) <= 1e-5


# ------------------------------------------------------------ the model

def _jax_inputs(a):
    from neural_jacobian_field_tpu.models import model as jm

    jcam = jm.CameraInput(input_image=jnp.asarray(a["image"]),
                          ctxt_extrinsics=jnp.asarray(a["ctxt"]),
                          ctxt_intrinsics=jnp.asarray(a["intr"]),
                          trgt_extrinsics=jnp.asarray(a["trgt"]),
                          trgt_intrinsics=jnp.asarray(a["intr"]))
    jri = jm.RenderingInput(origins=jnp.asarray(a["origins"]), directions=jnp.asarray(a["dirs"]),
                            z_near=jnp.asarray(a["near"]), z_far=jnp.asarray(a["far"]))
    jrobot = jm.RobotInput(robot_action=jnp.asarray(a["action"]))
    return jcam, jri, jrobot


@pytest.fixture(scope="module")
def setup():
    from neural_jacobian_field_tpu.models import model as jm

    a = scene_arrays()
    jcam, jri, jrobot = _jax_inputs(a)
    jmi = jm.ModelInput(camera_input=jcam, rendering_input=jri, robot_input=jrobot)
    ctx = jm.StepCtx(key=jax.random.PRNGKey(0), anneal=jnp.asarray(1.0),
                     updated=jnp.asarray(True))
    jmodel = jm.Model(cfg=_exact(jax_model_cfg()))
    variables = jmodel.init(jax.random.PRNGKey(0), jmi, ctx)
    variables = randomize_variables(jax.tree.map(np.asarray, dict(variables)))

    tmodel = Model(_exact(torch_model_cfg()))
    tmodel.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"]),
                           strict=True)
    tmodel.eval()
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    tcam = CameraInput(input_image=t["image"], ctxt_extrinsics=t["ctxt"],
                       ctxt_intrinsics=t["intr"], trgt_extrinsics=t["trgt"],
                       trgt_intrinsics=t["intr"])
    tri = RenderingInput(origins=t["origins"], directions=t["dirs"], z_near=t["near"],
                         z_far=t["far"])
    trobot = RobotInput(robot_action=t["action"])
    return dict(jmodel=jmodel, variables=variables, jcam=jcam, jri=jri, jrobot=jrobot, jmi=jmi,
                ctx=ctx, tmodel=tmodel, tcam=tcam, tri=tri, trobot=trobot,
                tmi=ModelInput(tcam, tri, trobot))


def test_exact_jax_tree_loads_through_the_bridge(setup):
    """The param tree does not depend on the feature mode: the JAX exact-mode
    params and batch statistics map leaf by leaf onto the port's exact-mode
    model, and onto an epipolar one alike (strict loads)."""
    s = setup
    sd = from_jax_variables(s["variables"]["params"], s["variables"]["batch_stats"])
    assert set(sd) == set(s["tmodel"].state_dict())
    Model(torch_model_cfg()).load_state_dict(sd, strict=True)


def test_exact_model_call_eval_matches_jax(setup):
    s = setup
    want = s["jmodel"].apply(s["variables"], s["jmi"], s["ctx"], train=False,
                             compute_vis_features=True)
    with torch.no_grad():
        got = s["tmodel"](s["tmi"], compute_vis_features=True)
    assert _rel(got.rgb, want.rgb) <= FIELD_TOL
    assert _rel(got.depth, want.depth) <= FIELD_TOL
    assert _rel(got.optical_flow, want.optical_flow) <= FIELD_TOL
    assert _rel(got.action_features, want.action_features) <= FIELD_TOL
    assert _rel(got.weights, want.weights) <= FIELD_TOL
    assert _rel(got.ray_positions, want.ray_positions) <= 1e-4
    assert _rel(got.steps, want.steps) <= 1e-4
    assert np.abs(np.asarray(want.optical_flow)).max() > 1e-3


def test_exact_encode_image_and_infer_optical_flow_match_jax(setup):
    from neural_jacobian_field_tpu.models.model import Model as JModel

    s = setup
    jenc = s["jmodel"].apply(s["variables"], s["jcam"], s["jri"], s["jrobot"], s["ctx"],
                             method=JModel.encode_image)
    tenc = s["tmodel"].encode_image(s["tcam"], s["tri"], s["trobot"])
    assert _rel(tenc.density, jenc.density) <= FIELD_TOL
    assert _rel(tenc.action_features, jenc.action_features) <= FIELD_TOL
    assert _rel(tenc.weights, jenc.weights) <= FIELD_TOL
    assert _rel(tenc.ray_samples_positions, jenc.ray_samples_positions) <= 1e-4
    want = s["jmodel"].apply(s["variables"], jenc, s["jcam"], s["jrobot"],
                             method=JModel.infer_optical_flow)
    got = s["tmodel"].infer_optical_flow(tenc, s["tcam"], s["trobot"])
    assert _rel(got.detach(), want) <= FIELD_TOL


def test_exact_bf16_path_on_cpu_tracks_f32_jax(setup):
    """The port in bf16 on the CPU takes the flagship branches of the exact
    path (K1's and the fused K7 trunk's plain versions; K9, K6, K5 plain
    versions). bf16 rounding through random O(1) weights moves rgb by
    several percent, so the bound is relative to the JAX package's own bf16
    model (on the CPU: the plain chain): the port's bf16 outputs may be at
    most twice as far from the f32 JAX outputs as JAX's bf16 outputs are,
    plus 1e-2."""
    from neural_jacobian_field_tpu.models import model as jm
    from neural_jacobian_field_torch.ops import kernels as K

    s = setup
    want = s["jmodel"].apply(s["variables"], s["jmi"], s["ctx"], train=False)
    ref_bf = jm.Model(cfg=_exact(jax_model_cfg()), compute_dtype=jnp.bfloat16).apply(
        s["variables"], s["jmi"], s["ctx"], train=False)
    bf = Model(_exact(torch_model_cfg()), compute_dtype=torch.bfloat16)
    bf.load_state_dict(s["tmodel"].state_dict(), strict=True)
    calls = []
    fused, onehot = K.field_mlp.fused_resnet_fc_plain, K.onehot_gather.onehot_gather_fwd_plain
    try:  # count the plain versions the CPU wrappers take
        K.field_mlp.fused_resnet_fc_plain = lambda *a: calls.append("K7") or fused(*a)
        K.onehot_gather.onehot_gather_fwd_plain = lambda *a: calls.append("K1") or onehot(*a)
        with torch.no_grad():
            got = bf(s["tmi"])
    finally:
        K.field_mlp.fused_resnet_fc_plain = fused
        K.onehot_gather.onehot_gather_fwd_plain = onehot
    assert calls.count("K7") == 3 and calls.count("K1") == 2, calls
    for name in ("rgb", "depth"):
        g = np.asarray(getattr(got, name), np.float64)
        w = np.asarray(getattr(want, name), np.float64)
        r = np.asarray(getattr(ref_bf, name), np.float64)
        assert np.isfinite(g).all()
        scale = 1.0 if name == "rgb" else np.abs(w).max()
        assert np.abs(g - w).max() / scale <= 2 * np.abs(r - w).max() / scale + 1e-2, name


# ------------------------------------------------------------ the train step

def _batch_arrays(seed=11, b=2):
    rng = np.random.default_rng(seed)
    h, w = IMAGE_HW
    return dict(
        ctxt_rgb=rng.integers(0, 256, size=(b, h, w, 3), dtype=np.uint8),
        ctxt_extrinsics=np.broadcast_to(np.eye(4, dtype=np.float32), (b, 4, 4)).copy(),
        ctxt_intrinsics=np.broadcast_to(INTRINSICS, (b, 3, 3)).copy(),
        robot_action=rng.normal(size=(b, 4)).astype(np.float32),
        trgt_rgb=rng.integers(0, 256, size=(b, h, w, 3), dtype=np.uint8),
        trgt_depth=rng.uniform(1.0, 3.5, size=(b, h, w, 1)).astype(np.float32),
        trgt_extrinsics=np.stack([look_at_offset(10.0), look_at_offset(-8.0)]),
        trgt_intrinsics=np.broadcast_to(INTRINSICS, (b, 3, 3)).copy(),
        near=np.full((b,), 0.5, np.float32), far=np.full((b,), 4.0, np.float32))


@pytest.fixture(scope="module")
def jax_steps():
    """Loss, metrics and parameter gradients of one JAX step per gate (the
    loss of make_train_step under value_and_grad), and the step's own draws."""
    from neural_jacobian_field_tpu.models import model as jm
    from neural_jacobian_field_tpu.training import prepare as jp
    from neural_jacobian_field_tpu.training import train as jt
    from neural_jacobian_field_tpu.training.losses import perception_loss

    arrays = _batch_arrays()
    jbatch = jp.RawBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jmodel = jm.Model(cfg=_exact(jax_model_cfg(), proposal_weights_anneal_max_num_iters=10 ** 9))
    jcfg = jt.TrainCfg(lr=LR, warm_up_steps=WARMUP, rays_per_batch=RAYS)
    st = jt.create_train_state(jax.random.PRNGKey(0), jmodel, jbatch, jcfg)
    variables = randomize_variables({"params": jax.tree.map(np.asarray, st.params),
                                     "batch_stats": jax.tree.map(np.asarray, st.batch_stats)})
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    samples = (*jmodel.cfg.rendering.num_proposal_samples, jmodel.cfg.rendering.num_nerf_samples)
    h, w = IMAGE_HW
    key = jax.random.PRNGKey(21)
    k_prep, k_samp = jax.random.split(key)
    yx = jax.random.uniform(k_prep, (RAYS, 2)) * jnp.array([h, w], jnp.float32)
    draws = [jax.random.uniform(k, (2, RAYS, s + 1))
             for k, s in zip(jax.random.split(k_samp, len(samples)), samples)]
    out = {"arrays": arrays, "variables": variables,
           "draws": (torch.from_numpy(np.array(yx.astype(jnp.int32))),
                     tuple(torch.from_numpy(np.array(d)) for d in draws))}
    for updated in (True, False):
        def loss_fn(p):
            mi, mt = jp.prepare_training_batch(k_prep, jbatch, RAYS)
            ctx = jm.StepCtx(key=k_samp, anneal=jm.step_schedules(
                jnp.asarray(0), jnp.asarray(0), jmodel.cfg.rendering)[0], updated=updated)
            o, _ = jmodel.apply({"params": p, "batch_stats": stats}, mi, ctx, train=True,
                                mutable=["batch_stats"])
            return perception_loss(o, mt, jcfg.loss)

        (_, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        out[updated] = dict(metrics=metrics, grads=grads)
    return out


@pytest.mark.parametrize("updated", [True, False])
def test_exact_train_step_matches_jax(jax_steps, updated):
    """One port train step in float32 from the same state, handed the JAX
    step's own pixel set and stratified draws: loss and metrics, and every
    parameter's gradient, within 5e-3 of scale; the proposal networks are
    reached on an update step only, the Jacobian head never."""
    from neural_jacobian_field_torch.training import RawBatch, TrainCfg, create_train_state
    from neural_jacobian_field_torch.training import train_step

    v = jax_steps["variables"]
    model = Model(_exact(torch_model_cfg(), proposal_weights_anneal_max_num_iters=10 ** 9))
    model.load_state_dict(from_jax_variables(v["params"], v["batch_stats"]), strict=True)
    state = create_train_state(model, TrainCfg(lr=LR, warm_up_steps=WARMUP, rays_per_batch=RAYS))
    yx, draws = jax_steps["draws"]
    batch = RawBatch(**{k: torch.from_numpy(a) for k, a in jax_steps["arrays"].items()})
    metrics = train_step(state, batch, updated=updated, yx=yx, draws=draws)
    ref = jax_steps[updated]
    assert set(metrics) == set(ref["metrics"])
    for k, w in ref["metrics"].items():
        assert abs(float(metrics[k]) - float(w)) <= FIELD_TOL * max(abs(float(w)), 1e-3), k
    want = from_jax_variables(jax.tree.map(np.asarray, ref["grads"]))
    for name, p in model.named_parameters():
        w = want[name].numpy()
        if not np.abs(w).max():
            assert not bool(p.grad.abs().max()), name
            continue
        assert _rel(p.grad.numpy(), w) <= FIELD_TOL, (name, _rel(p.grad.numpy(), w))
    reached = {n.split(".")[0] for n, g in want.items() if np.abs(g.numpy()).max() > 0}
    assert ("proposal_networks_0" in reached) == updated
    assert not any(np.abs(g.numpy()).max() for n, g in want.items() if "jacobian_head" in n)
