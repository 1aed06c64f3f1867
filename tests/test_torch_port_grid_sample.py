"""The concat feature layout of the port against the JAX package: the
bilinear lookup (ops/grid_sample.py) in both padding modes, values and
gradients through jax.vjp, in float64 (1e-12 of scale) and float32 (1e-6
of scale), at points inside the map, on its border and outside; the
encoder's concat map at num_layers 2 and 4, eval and training mode (1e-4
of scale, as test_torch_port_encoder.py); and the e2e configuration's
model (configurations/ with the e2e overrides: a 2-layer BatchNorm encoder,
so the concat layout, and small trunks) from the same params through
utils/from_jax.py: one eval forward with the visualisation features,
encode_image and infer_optical_flow, and one stage-1 train step with the
JAX step's own draws, at test_torch_port_exact.py's tolerances (5e-3 of
scale on the field and the gradients, 1e-4 on geometry).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import (
    IMAGE_HW, INTRINSICS, look_at_offset, randomize_variables, scene_arrays)
from neural_jacobian_field_torch.ops.grid_sample import grid_sample_bilinear
from neural_jacobian_field_torch.utils.from_jax import from_jax_variables

FIELD_TOL = 5e-3
RAYS = 16
LR, WARMUP = 1e-4, 4


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ------------------------------------------------------------ the lookup

def _points(rng, b=2, n=64):
    """xy in [-1, 1] coords: inside, exactly on the border (+-1, and pixel
    centres on it), and outside (|c| up to 1.6)."""
    inside = rng.uniform(-0.95, 0.95, size=(b, n, 2))
    border = rng.uniform(-1.0, 1.0, size=(b, 16, 2))
    border[:, :8, 0] = rng.choice([-1.0, 1.0], size=(b, 8))
    border[:, 8:, 1] = rng.choice([-1.0, 1.0], size=(b, 8))
    outside = rng.uniform(-1.6, 1.6, size=(b, 32, 2))
    outside[:, :, 0] = np.where(np.abs(outside[:, :, 0]) < 1.05, 1.3, outside[:, :, 0])
    return np.concatenate([inside, border, outside], axis=1)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_grid_sample_matches_jax(padding_mode, dtype):
    from neural_jacobian_field_tpu.ops.grid_sample import grid_sample_bilinear as jgs

    tol = 1e-12 if dtype == "float64" else 1e-6
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(2, 5, 7, 6)).astype(dtype)
    coords = _points(rng).astype(dtype)
    cot = rng.normal(size=(2, coords.shape[1], 6)).astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        want, vjp = jax.vjp(lambda f, c: jgs(f, c, padding_mode), jnp.asarray(feats),
                            jnp.asarray(coords))
        wf, wc = vjp(jnp.asarray(cot))
        want, wf, wc = np.asarray(want), np.asarray(wf), np.asarray(wc)
    assert want.dtype == np.dtype(dtype)
    f = torch.from_numpy(feats).requires_grad_(True)
    c = torch.from_numpy(coords).requires_grad_(True)
    got = grid_sample_bilinear(f, c, padding_mode)
    got.backward(torch.from_numpy(cot))
    assert got.dtype == f.dtype
    assert _rel(got.detach(), want) <= tol
    assert _rel(f.grad, wf) <= tol
    assert _rel(c.grad, wc) <= tol
    if padding_mode == "zeros":  # points well outside read nothing
        far = np.abs(coords).max(-1) > 1.0 + 2.0 / 4
        assert far.any() and not np.abs(got.detach().numpy()[far]).any()


def test_grid_sample_border_corner_values():
    """align_corners=True: the corners of [-1, 1]^2 are the corner texels,
    and coords beyond them read the same texels in border mode."""
    f = torch.arange(2 * 3 * 4, dtype=torch.float64).reshape(1, 3, 4, 2)
    c = torch.tensor([[[-1.0, -1.0], [1.0, 1.0], [-3.0, 5.0], [1.0, -1.0]]], dtype=torch.float64)
    out = grid_sample_bilinear(f, c)
    assert torch.equal(out[0], torch.stack([f[0, 0, 0], f[0, 2, 3], f[0, 2, 0], f[0, 0, 3]]))
    with pytest.raises(ValueError):
        grid_sample_bilinear(f, c, "reflection")


# ------------------------------------------------------------ the encoder

@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("num_layers", [2, 4])
def test_concat_encoder_matches_jax(num_layers, train):
    from neural_jacobian_field_tpu.models.encoder_resnet import (
        EncoderResnet as JEnc, EncoderResnetCfg as JCfg)
    from neural_jacobian_field_torch.models.encoder_resnet import (
        EncoderResnet, EncoderResnetCfg)

    h, w = IMAGE_HW
    img = np.random.default_rng(1).uniform(size=(2, h, w, 3)).astype(np.float32)
    # num_layers 2 takes the concat layout even where "pyramid" is asked for
    layout = "pyramid" if num_layers == 2 else "concat"
    jenc = JEnc(cfg=JCfg(norm_type="batch", conv_impl="xla", num_layers=num_layers,
                         feature_layout=layout))
    variables = jenc.init(jax.random.PRNGKey(0), jnp.asarray(img))
    variables = randomize_variables(jax.tree.map(np.asarray, dict(variables)))
    if train:
        want, upd = jenc.apply(variables, jnp.asarray(img), train=True, mutable=["batch_stats"])
    else:
        want = jenc.apply(variables, jnp.asarray(img), train=False)
    tenc = EncoderResnet(EncoderResnetCfg(norm_type="batch", conv_impl="xla",
                                          num_layers=num_layers, feature_layout=layout))
    tenc.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"]),
                         strict=True)
    with torch.no_grad():
        got = tenc(torch.from_numpy(img), train)
    assert isinstance(got, torch.Tensor)
    assert got.shape == (2, h // 2, w // 2, EncoderResnet.output_dim(tenc.cfg))
    assert got.shape[-1] == {2: 128, 4: 512}[num_layers]
    assert _rel(got, want) <= 1e-4
    if train:  # the running statistics moved as Flax's
        stats = from_jax_variables({}, upd["batch_stats"])
        for k, v in stats.items():
            assert _rel(tenc.state_dict()[k], v) <= 1e-4, k


# ------------------------------------------------------------ the model

def _cfgs():
    """The e2e configuration's model from configurations/ in both packages,
    its trunks cut to 2 blocks x 32 and 8 + 8 samples as the other parity
    tests cut theirs."""
    from neural_jacobian_field_tpu.config import get_typed_root_config as jroot
    from neural_jacobian_field_tpu.config import load_config as jload
    from neural_jacobian_field_tpu.train import CONFIG_DIR as JDIR
    from neural_jacobian_field_torch.config import CONFIG_DIR, get_typed_root_config, load_config

    ov = ["model.action_dim=4", "model.rendering.num_proposal_samples=[8]",
          "model.rendering.num_nerf_samples=8", "model.encoder.num_layers=2",
          "model.encoder.norm_type=batch", "model.density_decoder.mlp.n_blocks=2",
          "model.density_decoder.mlp.d_hidden=32", "model.action_decoder.mlp.n_blocks=2",
          "model.action_decoder.mlp.d_hidden=32",
          "model.rendering.proposal_weights_anneal_max_num_iters=1000000000"]
    return (jroot(jload(JDIR, ov)).model, get_typed_root_config(load_config(CONFIG_DIR, ov)).model)


def _jax_inputs(a):
    from neural_jacobian_field_tpu.models import model as jm

    jcam = jm.CameraInput(input_image=jnp.asarray(a["image"]),
                          ctxt_extrinsics=jnp.asarray(a["ctxt"]),
                          ctxt_intrinsics=jnp.asarray(a["intr"]),
                          trgt_extrinsics=jnp.asarray(a["trgt"]),
                          trgt_intrinsics=jnp.asarray(a["intr"]))
    jri = jm.RenderingInput(origins=jnp.asarray(a["origins"]), directions=jnp.asarray(a["dirs"]),
                            z_near=jnp.asarray(a["near"]), z_far=jnp.asarray(a["far"]))
    return jcam, jri, jm.RobotInput(robot_action=jnp.asarray(a["action"]))


@pytest.fixture(scope="module")
def concat_setup():
    from neural_jacobian_field_tpu.models import model as jm
    from neural_jacobian_field_torch.models.model import (
        CameraInput, Model, ModelInput, RenderingInput, RobotInput)

    jcfg, tcfg = _cfgs()
    a = scene_arrays()
    jcam, jri, jrobot = _jax_inputs(a)
    jmi = jm.ModelInput(camera_input=jcam, rendering_input=jri, robot_input=jrobot)
    ctx = jm.StepCtx(key=jax.random.PRNGKey(0), anneal=jnp.asarray(1.0),
                     updated=jnp.asarray(True))
    jmodel = jm.Model(cfg=jcfg)
    variables = jmodel.init(jax.random.PRNGKey(0), jmi, ctx)
    variables = randomize_variables(jax.tree.map(np.asarray, dict(variables)))
    tmodel = Model(tcfg)
    tmodel.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"]),
                           strict=True)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    tcam = CameraInput(input_image=t["image"], ctxt_extrinsics=t["ctxt"],
                       ctxt_intrinsics=t["intr"], trgt_extrinsics=t["trgt"],
                       trgt_intrinsics=t["intr"])
    tri = RenderingInput(origins=t["origins"], directions=t["dirs"], z_near=t["near"],
                         z_far=t["far"])
    trobot = RobotInput(robot_action=t["action"])
    return dict(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, variables=variables, jcam=jcam, jri=jri,
                jrobot=jrobot, jmi=jmi, ctx=ctx, tmodel=tmodel, tcam=tcam, tri=tri,
                trobot=trobot, tmi=ModelInput(tcam, tri, trobot))


def test_concat_model_is_the_e2e_configuration(concat_setup):
    """The configuration's encoder emits one 128-wide map, the trunks take it
    as one latent level, and the JAX tree loads strictly."""
    from neural_jacobian_field_torch.models.encoder_resnet import EncoderResnet

    s = concat_setup
    assert s["tcfg"].encoder.feature_layout == "pyramid" and s["tcfg"].encoder.num_layers == 2
    assert EncoderResnet.output_dim(s["tcfg"].encoder) == 128
    assert s["tcfg"].rendering.use_fused_trunk and s["tcfg"].rendering.pixel_feature_mode == (
        "epipolar")
    enc = s["tmodel"].compute_pixel_encoding(s["tcam"], s["trobot"])
    assert isinstance(enc.features, torch.Tensor) and enc.features.shape[-1] == 128
    assert s["tmodel"].attach_ray_features(enc, None) is enc  # a no-op on one map


def test_concat_model_call_eval_matches_jax(concat_setup):
    s = concat_setup
    want = s["jmodel"].apply(s["variables"], s["jmi"], s["ctx"], train=False,
                             compute_vis_features=True)
    with torch.no_grad():
        got = s["tmodel"](s["tmi"], compute_vis_features=True)
    for name in ("rgb", "depth", "optical_flow", "action_features", "weights"):
        assert _rel(getattr(got, name), getattr(want, name)) <= FIELD_TOL, name
    assert _rel(got.ray_positions, want.ray_positions) <= 1e-4
    assert _rel(got.steps, want.steps) <= 1e-4
    assert np.abs(np.asarray(want.optical_flow)).max() > 1e-3


def test_concat_serving_chunk_matches_jax(concat_setup):
    """render_camera's chunked path (the serving chunk, on the CPU run
    eagerly) at 8x12 in 32-ray chunks against JAX's render_camera. The two
    packages compute the 96 camera rays in another float32 order, and where
    a sample lands on a steep stretch of the top NeRF frequency that
    rounding moves a pixel by up to ~1e-2 of scale (the eval forward's 16
    rays happen to stay under 5e-3). So per pixel: the median error of rgb,
    depth, the composited Jacobian and the weights at most 1e-4 of scale,
    the largest at most 2e-2; the flow the same where it is well
    conditioned (under 5 px: where the composited point projects near the
    target camera's plane, a flow of hundreds of pixels amplifies it)."""
    from neural_jacobian_field_tpu.inference.render import render_camera as jrender
    from neural_jacobian_field_torch.inference.render import render_camera

    s = concat_setup
    want = jrender(s["jmodel"], s["variables"], s["jcam"], s["jrobot"], z_near=0.5, z_far=4.0,
                   height=8, width=12, patch_size=32)
    got = render_camera(s["tmodel"], s["tcam"], s["trobot"], 0.5, 4.0, 8, 12, patch_size=32)
    assert got.rgb.shape == (1, 8, 12, 3)

    def per_pixel(g, w, keep=None):
        g, w = np.asarray(g, np.float64).reshape(96, -1), np.asarray(w, np.float64).reshape(96, -1)
        if keep is not None:
            g, w = g[keep], w[keep]
        assert np.isfinite(g).all()
        err = np.abs(g - w).max(-1) / np.abs(w).max()
        return np.median(err), err.max()

    for name in ("rgb", "depth_raw", "action_features", "weights"):
        med, top = per_pixel(getattr(got, name), getattr(want, name))
        assert med <= 1e-4 and top <= 2e-2, (name, med, top)
    calm = np.linalg.norm(np.asarray(want.flow_raw), axis=-1).reshape(96) < 5.0
    assert calm.mean() > 0.5
    med, top = per_pixel(got.flow_raw, want.flow_raw, calm)
    assert med <= 1e-4 and top <= 2e-2, ("flow_raw", med, top)


def test_concat_encode_image_and_infer_optical_flow_match_jax(concat_setup):
    from neural_jacobian_field_tpu.models.model import Model as JModel

    s = concat_setup
    jenc = s["jmodel"].apply(s["variables"], s["jcam"], s["jri"], s["jrobot"], s["ctx"],
                             method=JModel.encode_image)
    tenc = s["tmodel"].encode_image(s["tcam"], s["tri"], s["trobot"])
    assert _rel(tenc.density, jenc.density) <= FIELD_TOL
    assert _rel(tenc.action_features, jenc.action_features) <= FIELD_TOL
    assert _rel(tenc.ray_samples_positions, jenc.ray_samples_positions) <= 1e-4
    want = s["jmodel"].apply(s["variables"], jenc, s["jcam"], s["jrobot"],
                             method=JModel.infer_optical_flow)
    got = s["tmodel"].infer_optical_flow(tenc, s["tcam"], s["trobot"])
    assert _rel(got.detach(), want) <= FIELD_TOL


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


def test_concat_train_step_matches_jax():
    """One stage-1 step (an update step) of the e2e model in float32 from the
    same state, the port handed the JAX step's pixel set and stratified
    draws: the metrics and every parameter's gradient within 5e-3 of
    scale."""
    from neural_jacobian_field_tpu.models import model as jm
    from neural_jacobian_field_tpu.training import prepare as jp
    from neural_jacobian_field_tpu.training import train as jt
    from neural_jacobian_field_tpu.training.losses import perception_loss
    from neural_jacobian_field_torch.models.model import Model
    from neural_jacobian_field_torch.training import (
        RawBatch, TrainCfg, create_train_state, train_step)

    jcfg, tcfg = _cfgs()
    arrays = _batch_arrays()
    jbatch = jp.RawBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jmodel = jm.Model(cfg=jcfg)
    st = jt.create_train_state(jax.random.PRNGKey(0), jmodel, jbatch,
                               jt.TrainCfg(lr=LR, warm_up_steps=WARMUP, rays_per_batch=RAYS))
    variables = randomize_variables({"params": jax.tree.map(np.asarray, st.params),
                                     "batch_stats": jax.tree.map(np.asarray, st.batch_stats)})
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    h, w = IMAGE_HW
    k_prep, k_samp = jax.random.split(jax.random.PRNGKey(21))
    yx = jax.random.uniform(k_prep, (RAYS, 2)) * jnp.array([h, w], jnp.float32)
    draws = [jax.random.uniform(k, (2, RAYS, s + 1))
             for k, s in zip(jax.random.split(k_samp, 2), (8, 8))]

    def loss_fn(p):
        mi, mt = jp.prepare_training_batch(k_prep, jbatch, RAYS)
        ctx = jm.StepCtx(key=k_samp, anneal=jm.step_schedules(
            jnp.asarray(0), jnp.asarray(0), jcfg.rendering)[0], updated=True)
        o, _ = jmodel.apply({"params": p, "batch_stats": stats}, mi, ctx, train=True,
                            mutable=["batch_stats"])
        return perception_loss(o, mt)

    (_, ref), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, variables["params"]))

    model = Model(tcfg)
    model.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"]),
                          strict=True)
    state = create_train_state(model, TrainCfg(lr=LR, warm_up_steps=WARMUP, rays_per_batch=RAYS))
    batch = RawBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    metrics = train_step(state, batch, updated=True,
                         yx=torch.from_numpy(np.array(yx.astype(jnp.int32))),
                         draws=tuple(torch.from_numpy(np.array(d)) for d in draws))
    assert set(metrics) == set(ref)
    for k, v in ref.items():
        assert abs(float(metrics[k]) - float(v)) <= FIELD_TOL * max(abs(float(v)), 1e-3), k
    want = from_jax_variables(jax.tree.map(np.asarray, grads))
    for name, p in model.named_parameters():
        wg = want[name].numpy()
        if not np.abs(wg).max():
            assert not bool(p.grad.abs().max()), name
            continue
        assert _rel(p.grad.numpy(), wg) <= FIELD_TOL, (name, _rel(p.grad.numpy(), wg))
    assert np.abs(want["encoder.layer1_block0.conv1.weight"].numpy()).max() > 0
