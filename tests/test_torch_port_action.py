"""Stage 2 (action) training of the port against the JAX package, in float32
on the CPU: batch preparation with flow and with tracks supervision, the
action loss, the trainable mask, and the whole stage-2 train step.

The step runs the small flagship-shaped model of tests/_torch_port_common.py
with seeded random weights and BatchNorm statistics, a batch of 2 uint8
images, from the same state on both sides, the port handed the JAX step's
own randomness (as tests/test_torch_port_train_step.py does), in three
settings: epipolar features with flow supervision at 16 shared rays,
epipolar with 12 tracks per example (a visibility mask with hidden tracks),
and exact features with flow. The port's encoder runs conv_impl=
"pallas_fused", the setting its stage 2 runs on the card, so every stride-1
3x3 conv goes through K10 (its plain version here); the JAX encoder runs
its XLA convs, whose BatchNorm takes the same float32 statistics in another
summation order. The anneal exponent is held at ~0 and the learning rate is
small, as in the stage-1 step test, for the same reasons.
"""

from dataclasses import replace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import (
    INTRINSICS, IMAGE_HW, jax_model_cfg, look_at_offset, randomize_variables,
    torch_model_cfg)
from neural_jacobian_field_torch.ops.kernels import conv_suite
from neural_jacobian_field_torch.utils.from_jax import from_jax_variables

RAYS, TRACKS = 16, 12
LR, WARMUP = 1e-4, 4
TOL = 5e-3
CASES = [("epipolar", "flow"), ("epipolar", "tracks"), ("exact", "flow")]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _batch_arrays(supervision, seed=11, b=2):
    rng = np.random.default_rng(seed)
    h, w = IMAGE_HW
    a = dict(
        ctxt_rgb=rng.integers(0, 256, size=(b, h, w, 3), dtype=np.uint8),
        ctxt_extrinsics=np.broadcast_to(np.eye(4, dtype=np.float32), (b, 4, 4)).copy(),
        ctxt_intrinsics=np.broadcast_to(INTRINSICS, (b, 3, 3)).copy(),
        robot_action=rng.normal(size=(b, 4)).astype(np.float32),
        trgt_rgb=rng.integers(0, 256, size=(b, h, w, 3), dtype=np.uint8),
        trgt_depth=rng.uniform(1.0, 3.5, size=(b, h, w, 1)).astype(np.float32),
        trgt_extrinsics=np.stack([look_at_offset(10.0), look_at_offset(-8.0)]),
        trgt_intrinsics=np.broadcast_to(INTRINSICS, (b, 3, 3)).copy(),
        near=np.full((b,), 0.5, np.float32), far=np.full((b,), 4.0, np.float32))
    if supervision == "flow":
        a["flow"] = (3.0 * rng.normal(size=(b, h, w, 2))).astype(np.float32)
    else:
        a["pixel_selector"] = rng.integers(0, h * w, size=(b, TRACKS)).astype(np.int32)
        a["pixel_motion"] = (3.0 * rng.normal(size=(b, TRACKS, 2))).astype(np.float32)
        mask = np.ones((b, TRACKS), np.float32)
        mask[0, :3] = 0.0
        mask[1, -2:] = 0.0
        a["pixel_visible_mask"] = mask
    return a


def _jax_batch(arrays):
    from neural_jacobian_field_tpu.training import prepare as jp

    return jp.RawBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _port_batch(arrays):
    from neural_jacobian_field_torch.training import RawBatch

    return RawBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()})


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------- modules

@pytest.mark.parametrize("supervision", ["flow", "tracks"])
def test_prepare_action_batch_matches_jax(supervision):
    """Flow at the shared pixel set (JAX's own draw), or each example's
    tracks gathered at its own pixels with their motion and mask: every
    model input and target agrees to float32 rounding (1e-6)."""
    from neural_jacobian_field_tpu.training import prepare as jp
    from neural_jacobian_field_torch.training import prepare_training_batch

    arrays = _batch_arrays(supervision)
    key = jax.random.PRNGKey(5)
    jmi, jmt = jp.prepare_training_batch(key, _jax_batch(arrays), RAYS, mode="action")
    h, w = IMAGE_HW
    yx = np.array((jax.random.uniform(key, (RAYS, 2)) * jnp.array([h, w], jnp.float32))
                  .astype(jnp.int32))
    tmi, tmt = prepare_training_batch(_port_batch(arrays), RAYS, yx=torch.from_numpy(yx),
                                      mode="action")
    pairs = [(tmt.rgb, jmt.rgb), (tmt.depth, jmt.depth), (tmt.optical_flow, jmt.optical_flow),
             (tmi.rendering_input.origins, jmi.rendering_input.origins),
             (tmi.rendering_input.directions, jmi.rendering_input.directions),
             (tmi.camera_input.trgt_intrinsics, jmi.camera_input.trgt_intrinsics)]
    if supervision == "tracks":
        assert tmt.rgb.shape[:2] == (2, TRACKS)
        pairs.append((tmt.visible_mask, jmt.visible_mask))
    else:
        assert tmt.visible_mask is None and jmt.visible_mask is None
    for got, want in pairs:
        assert _rel(_np(got), want) <= 1e-6


@pytest.mark.parametrize("mask", ["none", "some", "all_hidden"])
def test_action_loss_matches_jax(mask):
    """0.01 x the squared flow error: the mean over every component without
    a mask; with one, summed over the visible rays and divided by their
    number, at least 1 (1e-6)."""
    from neural_jacobian_field_tpu.models.model import ModelOutput as JOut
    from neural_jacobian_field_tpu.models.model import ModelTarget as JTarget
    from neural_jacobian_field_tpu.training.losses import action_loss as j_action_loss
    from neural_jacobian_field_torch.models.model import ModelOutput, ModelTarget
    from neural_jacobian_field_torch.training import action_loss

    rng = np.random.default_rng(2)
    pred, target = (rng.normal(size=(2, 9, 2)).astype(np.float32) for _ in range(2))
    vis = None if mask == "none" else (
        (rng.uniform(size=(2, 9)) > 0.4).astype(np.float32) if mask == "some"
        else np.zeros((2, 9), np.float32))
    zeros = np.zeros((2, 9, 1), np.float32)
    jl, jm = j_action_loss(
        JOut(rgb=zeros, depth=zeros, optical_flow=jnp.asarray(pred)),
        JTarget(rgb=zeros, depth=zeros, optical_flow=jnp.asarray(target),
                visible_mask=None if vis is None else jnp.asarray(vis)))
    tpred = torch.from_numpy(pred).requires_grad_()
    tl, tm = action_loss(
        ModelOutput(rgb=torch.zeros(2, 9, 3), depth=torch.zeros(2, 9, 1), optical_flow=tpred),
        ModelTarget(rgb=torch.zeros(2, 9, 3), depth=torch.zeros(2, 9, 1),
                    optical_flow=torch.from_numpy(target),
                    visible_mask=None if vis is None else torch.from_numpy(vis)))
    assert set(tm) == set(jm)
    assert abs(float(tl.detach()) - float(jl)) <= 1e-6 * max(abs(float(jl)), 1e-3)
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6, abs=1e-9)
    if mask == "all_hidden":
        assert float(tl.detach()) == 0.0
    tl.backward()
    assert tpred.grad is not None


def test_trainable_mask_labels_as_jax():
    """Stage 2 trains the leaves whose path has the decoder's action pattern
    (the Jacobian head), and freezes every other leaf, on both sides; stage
    1 trains all."""
    from neural_jacobian_field_tpu.models import model as jm
    from neural_jacobian_field_tpu.training import train as jt
    from neural_jacobian_field_torch.models.model import Model
    from neural_jacobian_field_torch.training import trainable_mask

    jmodel = jm.Model(cfg=jax_model_cfg())
    arrays = _batch_arrays("flow")
    st = jt.create_train_state(jax.random.PRNGKey(0), jmodel, _jax_batch(arrays),
                               jt.TrainCfg(rays_per_batch=RAYS))
    model = Model(torch_model_cfg())
    for mode in ("action", "perception"):
        labels = jt.trainable_mask(st.params, mode, jmodel.cfg.action_decoder)
        # a float tree of the params' shapes, 1 where trainable, through the bridge
        ones = jax.tree.map(lambda p, lab: np.full(p.shape, float(lab == "trainable"), np.float32),
                            st.params, labels)
        want = {k: bool(v.numpy().all()) for k, v in from_jax_variables(ones).items()}
        got = trainable_mask(model, mode, model.cfg.action_decoder)
        assert set(got) == set(want) == {n for n, _ in model.named_parameters()}
        assert {k: v == "trainable" for k, v in got.items()} == want
    trained = [k for k, v in trainable_mask(model, "action", model.cfg.action_decoder).items()
               if v == "trainable"]
    assert trained and all(k.startswith("decoder.jacobian_head.") for k in trained)


# ------------------------------------------------------------ the train step

def _cfgs(features):
    jcfg, tcfg = jax_model_cfg(), torch_model_cfg()
    rendering = dict(proposal_weights_anneal_max_num_iters=10 ** 9)
    if features == "exact":
        rendering["pixel_feature_mode"] = "exact"
    jcfg = replace(jcfg, rendering=replace(jcfg.rendering, **rendering))
    tcfg = replace(tcfg, rendering=replace(tcfg.rendering, **rendering),
                   encoder=replace(tcfg.encoder, conv_impl="pallas_fused"))
    return jcfg, tcfg


def _jax_draws(key, arrays, samples):
    """The JAX step's pixel set (flow supervision) and stratified jitter."""
    k_prep, k_samp = jax.random.split(key)
    b, h, w = arrays["trgt_rgb"].shape[:3]
    n = arrays["pixel_selector"].shape[1] if "pixel_selector" in arrays else RAYS
    yx = jax.random.uniform(k_prep, (RAYS, 2)) * jnp.array([h, w], jnp.float32)
    keys = jax.random.split(k_samp, len(samples))
    draws = [jax.random.uniform(k, (b, n, s + 1)) for k, s in zip(keys, samples)]
    return (torch.from_numpy(np.array(yx.astype(jnp.int32))),
            tuple(torch.from_numpy(np.array(d)) for d in draws))


@pytest.fixture(scope="module")
def action_steps():
    """Per case: the JAX stage-2 step (make_train_step, mode "action", the
    proposal gate static) from a seeded state, the Jacobian head's gradients
    of its loss, and the step's draws; for the first case also a second
    step from the state after the first."""
    from neural_jacobian_field_tpu.models import model as jm
    from neural_jacobian_field_tpu.training import prepare as jp
    from neural_jacobian_field_tpu.training import train as jt
    from neural_jacobian_field_tpu.training.losses import action_loss as j_action_loss

    out = {}
    for features, supervision in CASES:
        arrays = _batch_arrays(supervision)
        jbatch = _jax_batch(arrays)
        jmodel = jm.Model(cfg=_cfgs(features)[0])
        jcfg = jt.TrainCfg(mode="action", lr=LR, warm_up_steps=WARMUP, rays_per_batch=RAYS)
        st = jt.create_train_state(jax.random.PRNGKey(0), jmodel, jbatch, jcfg)
        variables = randomize_variables({"params": jax.tree.map(np.asarray, st.params),
                                         "batch_stats": jax.tree.map(np.asarray, st.batch_stats)})
        params = jax.tree.map(jnp.asarray, variables["params"])
        stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
        tx = jt.make_optimizer(jcfg, params, jmodel.cfg.action_decoder)
        st = st.replace(params=params, batch_stats=stats, opt_state=tx.init(params))
        rcfg = jmodel.cfg.rendering
        samples = (*rcfg.num_proposal_samples, rcfg.num_nerf_samples)
        key = jax.random.PRNGKey(21)
        step = jt.make_train_step(jmodel, jcfg, donate=False, static_updated=True)
        new, metrics = step(st, jbatch, key)

        @jax.jit
        def grads(p, key=key):
            k_prep, k_samp = jax.random.split(key)
            anneal = jm.step_schedules(jnp.asarray(0), jnp.asarray(0), rcfg)[0]
            mi, mt = jp.prepare_training_batch(k_prep, jbatch, RAYS, mode="action")
            ctx = jm.StepCtx(key=k_samp, anneal=anneal, updated=True)

            def loss_fn(pp):
                o, _ = jmodel.apply({"params": jt.stop_frozen_gradients(
                    pp, "action", jmodel.cfg.action_decoder), "batch_stats": stats}, mi, ctx,
                    train=True, mutable=["batch_stats"])
                return j_action_loss(o, mt, jcfg.loss)[0]

            return jax.grad(loss_fn)(p)

        case = dict(arrays=arrays, variables=variables, new=new, metrics=metrics,
                    grads=grads(params), draws=_jax_draws(key, arrays, samples))
        if (features, supervision) == CASES[0]:
            key2 = jax.random.PRNGKey(22)
            new2, metrics2 = step(new, jbatch, key2)
            case["second"] = dict(start=new, new=new2, metrics=metrics2,
                                  draws=_jax_draws(key2, arrays, samples))
        out[(features, supervision)] = case
    return out


def _port_state(tcfg, params, batch_stats):
    from neural_jacobian_field_torch.models.model import Model
    from neural_jacobian_field_torch.training import TrainCfg, create_train_state

    model = Model(tcfg)
    model.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, params),
                                             jax.tree.map(np.asarray, batch_stats)), strict=True)
    return create_train_state(model, TrainCfg(mode="action", lr=LR, warm_up_steps=WARMUP,
                                              rays_per_batch=RAYS))


def _counted_k10(calls):
    plain = conv_suite.conv3x3_s1_stats

    def counted(x, w):
        calls.append(tuple(x.shape))
        return plain(x, w)

    return mock.patch.object(conv_suite, "conv3x3_s1_stats", counted)


def _check_after_step(model, before, want_params, want_stats):
    """The Jacobian head's displacement on the lr scale (as the stage-1 step
    test: at most 1% of a tensor's elements further apart than 1e-2 lr, none
    beyond 2 lr); every other parameter bit-identical to before; the
    running statistics equal to JAX's new batch_stats (1e-5 of scale)."""
    want = from_jax_variables(jax.tree.map(np.asarray, want_params))
    for name, p in model.named_parameters():
        if "jacobian_head" not in name:
            assert torch.equal(p.detach(), before[name]), name
            continue
        d_got = p.detach().numpy() - before[name].numpy()
        d_want = want[name].numpy() - before[name].numpy()
        err = np.abs(d_got - d_want) / LR
        assert np.abs(d_want).max() > 0, name
        far = int((err > 1e-2).sum())
        assert far <= max(1, err.size // 100) and err.max() <= 2.0 + 1e-3, (name, far, err.max())
    stats = from_jax_variables({}, jax.tree.map(np.asarray, want_stats))
    bufs = dict(model.named_buffers())
    for name, v in stats.items():
        assert _rel(bufs[name].numpy(), v.numpy()) <= 1e-5, name


@pytest.mark.parametrize("features,supervision", CASES)
def test_action_train_step_matches_jax(action_steps, features, supervision):
    """One port stage-2 step from the same state with JAX's draws: the flow
    loss, the Jacobian head's gradients (5e-3 of scale), no gradient on any
    other parameter, the head after Adam, every other parameter unchanged
    bit for bit, and the running statistics moved as JAX's (the encoder
    runs in training mode in stage 2 too), with K10 at the stride-1 convs
    JAX takes statistics from: layer1 (8x12) and layer2 (4x6), 13 convs;
    layer3's 2x3 is off JAX's row-block family, so its 11 BatchNorms sum
    y."""
    from neural_jacobian_field_torch.training import train_step

    ref = action_steps[(features, supervision)]
    v = ref["variables"]
    state = _port_state(_cfgs(features)[1], v["params"], v["batch_stats"])
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    yx, draws = ref["draws"]
    calls = []
    with _counted_k10(calls):
        metrics = train_step(state, _port_batch(ref["arrays"]), updated=True, yx=yx,
                             draws=draws)
    assert len(calls) == 13
    assert set(metrics) == set(ref["metrics"]) == {"loss/flow", "loss/total"}
    for k, w in ref["metrics"].items():
        assert abs(float(metrics[k]) - float(w)) <= TOL * abs(float(w)), k
    want = from_jax_variables(jax.tree.map(np.asarray, ref["grads"]))
    for name, p in state.model.named_parameters():
        if "jacobian_head" in name:
            assert _rel(p.grad.numpy(), want[name].numpy()) <= TOL, name
        else:
            assert not p.requires_grad and p.grad is None, name
            assert not np.abs(want[name].numpy()).max(), name
    _check_after_step(state.model, before, ref["new"].params, ref["new"].batch_stats)


def test_second_action_step_from_carried_optax_state(action_steps):
    """The JAX state after one stage-2 step carried over to the port: its
    optax multi_transform Adam state holds the trainable partition alone,
    which is what the port's optimizer holds; then one more step on both
    sides."""
    from neural_jacobian_field_torch.training import train_step
    from neural_jacobian_field_torch.utils.from_jax import load_optax_adam_state

    ref = action_steps[CASES[0]]["second"]
    start = ref["start"]
    state = _port_state(_cfgs(CASES[0][0])[1], start.params, start.batch_stats)
    adam = [s for s in jax.tree.leaves(start.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
            if hasattr(s, "mu")]
    load_optax_adam_state(state.optimizer, state.model, *adam)
    held = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert {id(p) for p in state.optimizer.state} == held
    state.step, state.steps_since_update = int(start.step), int(start.steps_since_update)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    yx, draws = ref["draws"]
    metrics = train_step(state, _port_batch(action_steps[CASES[0]]["arrays"]), updated=True,
                         yx=yx, draws=draws)
    for k, w in ref["metrics"].items():
        assert abs(float(metrics[k]) - float(w)) <= TOL * abs(float(w)), k
    _check_after_step(state.model, before, ref["new"].params, ref["new"].batch_stats)
