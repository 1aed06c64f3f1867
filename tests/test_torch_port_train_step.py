"""The whole stage-1 train step of the port against the JAX package's
`make_train_step`, in float32 on the CPU.

The small flagship-shaped model of tests/_torch_port_common.py with seeded
random weights and BatchNorm statistics, a batch of 2 uint8 images, 16 rays.
Both sides start from the same state; the port is handed the JAX step's own
randomness, drawn in the test with the JAX step's key splits: the pixel set
from `k_prep`, then split(k_samp, 2) for the spaced jitter and the PDF
jitter. One step with the proposal gate given statically (update and frozen),
then a second step from the JAX state after the first, its optax Adam state
carried over through utils/from_jax.load_optax_adam_state.

Two amplifiers of float32 rounding are held off, so that the comparison is
of the algorithm: (1) the proposal anneal exponent stays ~0 over both steps
(anneal_max_num_iters 1e9), so the resampled positions do not depend on the
proposal weights' rounding, which the top NeRF frequency (2*pi*2^9) would
turn into percents of some gradients (measured: 3.6% on one tensor at step
1's anneal); the anneal itself is compared in test_torch_port_train_modules;
(2) the learning rate is small, because after a full-size Adam step some
BatchNorm channels of the 2x3 coarse level have a batch variance that the
(Flax) E[y^2] - E[y]^2 cancels to a few digits, which moves their gradients
by ~10% with the summation order (measured). Both sides then compute the
same float32 operations in other orders: losses, metrics and gradients agree
to 5e-3 of each tensor's scale, the field tolerance of the serving tests
(measured: 1.03e-3). Adam normalises each gradient element, so a
parameter's displacement is compared with the lr as the scale: at most 1%
of a tensor's elements (or one element) further apart than 1e-2 lr, since
an element whose gradient is ~0 may differ in sign, and none by more than
2 lr (measured: 0.07% of a tensor's elements, 0.59 lr).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import (
    INTRINSICS, IMAGE_HW, jax_model_cfg, look_at_offset, randomize_variables,
    torch_model_cfg)
from neural_jacobian_field_torch.utils.from_jax import from_jax_variables

RAYS = 16
HW = IMAGE_HW
LR, WARMUP = 1e-4, 4
GRAD_TOL = 5e-3
ANNEAL_ITERS = 10 ** 9


def _with_anneal_off(cfg):
    from dataclasses import replace

    return replace(cfg, rendering=replace(cfg.rendering,
                                          proposal_weights_anneal_max_num_iters=ANNEAL_ITERS))


def _batch_arrays(seed=11, b=2):
    rng = np.random.default_rng(seed)
    h, w = HW
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


def _jax_draws(key, b, h, w, samples):
    """The JAX step's pixel set and stratified jitter, from its own key."""
    k_prep, k_samp = jax.random.split(key)
    yx = (jax.random.uniform(k_prep, (RAYS, 2)) * jnp.array([h, w], jnp.float32))
    keys = jax.random.split(k_samp, len(samples))
    draws = [jax.random.uniform(k, (b, RAYS, s + 1)) for k, s in zip(keys, samples)]
    return (torch.from_numpy(np.array(yx.astype(jnp.int32))),
            tuple(torch.from_numpy(np.array(d)) for d in draws))


def _jax_grads(jmodel, jbatch, jcfg, state, key, updated):
    """The parameter gradients of one JAX step (the loss of make_train_step,
    under value_and_grad)."""
    from neural_jacobian_field_tpu.models import model as jm
    from neural_jacobian_field_tpu.training import prepare as jp
    from neural_jacobian_field_tpu.training.losses import perception_loss

    @jax.jit
    def grads(state, key):
        k_prep, k_samp = jax.random.split(key)
        anneal, _, _ = jm.step_schedules(state.step, state.steps_since_update,
                                         jmodel.cfg.rendering)
        mi, mt = jp.prepare_training_batch(k_prep, jbatch, RAYS)
        ctx = jm.StepCtx(key=k_samp, anneal=anneal, updated=updated)

        def loss_fn(p):
            out, _ = jmodel.apply({"params": p, "batch_stats": state.batch_stats}, mi, ctx,
                                  train=True, mutable=["batch_stats"])
            return perception_loss(out, mt, jcfg.loss)[0]

        return jax.grad(loss_fn)(state.params)

    return grads(state, key)


@pytest.fixture(scope="module")
def steps():
    """Run every JAX step once (two compiled gates, value_and_grad of each)
    and return what the tests compare against."""
    from neural_jacobian_field_tpu.models import model as jm
    from neural_jacobian_field_tpu.training import prepare as jp
    from neural_jacobian_field_tpu.training import train as jt

    arrays = _batch_arrays()
    jbatch = jp.RawBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jmodel = jm.Model(cfg=_with_anneal_off(jax_model_cfg()))
    jcfg = jt.TrainCfg(lr=LR, warm_up_steps=WARMUP, rays_per_batch=RAYS)
    st = jt.create_train_state(jax.random.PRNGKey(0), jmodel, jbatch, jcfg)
    variables = randomize_variables({"params": jax.tree.map(np.asarray, st.params),
                                     "batch_stats": jax.tree.map(np.asarray, st.batch_stats)})
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    tx = jt.make_optimizer(jcfg, params)
    st = st.replace(params=params, batch_stats=stats, opt_state=tx.init(params))
    samples = (*jmodel.cfg.rendering.num_proposal_samples, jmodel.cfg.rendering.num_nerf_samples)

    h, w = HW
    out = {"arrays": arrays, "variables": variables, "samples": samples}
    for updated in (True, False):
        key = jax.random.PRNGKey(21)
        step = jt.make_train_step(jmodel, jcfg, donate=False, static_updated=updated)
        new, metrics = step(st, jbatch, key)
        g = _jax_grads(jmodel, jbatch, jcfg, st, key, updated)
        out[updated] = dict(new=new, metrics=metrics, grads=g,
                            draws=_jax_draws(key, 2, h, w, samples))
    # a second step from the state after the first update step
    key2 = jax.random.PRNGKey(22)
    first = out[True]["new"]
    step = jt.make_train_step(jmodel, jcfg, donate=False, static_updated=True)
    new2, metrics2 = step(first, jbatch, key2)
    out["second"] = dict(start=first, new=new2, metrics=metrics2,
                         draws=_jax_draws(key2, 2, h, w, samples))
    return out


def _port_state(params, batch_stats):
    from neural_jacobian_field_torch.models.model import Model
    from neural_jacobian_field_torch.training import TrainCfg, create_train_state

    model = Model(_with_anneal_off(torch_model_cfg()))
    model.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, params),
                                             jax.tree.map(np.asarray, batch_stats)),
                          strict=True)
    return create_train_state(model, TrainCfg(lr=LR, warm_up_steps=WARMUP,
                                              rays_per_batch=RAYS))


def _port_batch(arrays):
    from neural_jacobian_field_torch.training import RawBatch

    return RawBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()})


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _check_metrics(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= GRAD_TOL * max(abs(float(v)), 1e-3), k


def _check_params_after_adam(model, before, after):
    """Displacements on the lr scale (see the module docstring)."""
    want = from_jax_variables(jax.tree.map(np.asarray, after))
    start = from_jax_variables(jax.tree.map(np.asarray, before))
    for name, p in model.named_parameters():
        d_got = p.detach().numpy() - start[name].numpy()
        d_want = want[name].numpy() - start[name].numpy()
        err = np.abs(d_got - d_want) / LR
        assert np.abs(d_want).max() > 0, name  # every parameter moves, reached or not
        far = int((err > 1e-2).sum())
        assert far <= max(1, err.size // 100) and err.max() <= 2.0 + 1e-3, (name, far, err.max())


def _check_stats(model, want_stats):
    want = from_jax_variables({}, jax.tree.map(np.asarray, want_stats))
    bufs = dict(model.named_buffers())
    for name, v in want.items():
        assert _rel(bufs[name].numpy(), v.numpy()) <= 1e-5, name


@pytest.mark.parametrize("updated", [True, False])
def test_train_step_matches_jax(steps, updated):
    """Loss and metrics, every parameter's gradient, every parameter after
    Adam (the Jacobian head, which stage 1 does not reach, and on a frozen
    step the proposal networks move by decay and Adam alone), and the new
    BatchNorm statistics."""
    from neural_jacobian_field_torch.training import train_step

    ref = steps[updated]
    v = steps["variables"]
    state = _port_state(v["params"], v["batch_stats"])
    yx, draws = ref["draws"]
    metrics = train_step(state, _port_batch(steps["arrays"]), updated=updated, yx=yx,
                         draws=draws)
    assert state.step == 1
    assert state.steps_since_update == int(ref["new"].steps_since_update)
    _check_metrics(metrics, ref["metrics"])

    want = from_jax_variables(jax.tree.map(np.asarray, ref["grads"]))
    for name, p in state.model.named_parameters():
        w = want[name].numpy()
        if not np.abs(w).max():
            assert not bool(p.grad.abs().max()), name
            continue
        assert _rel(p.grad.numpy(), w) <= GRAD_TOL, (name, _rel(p.grad.numpy(), w))
    reached = {n.split(".")[0] for n, g in want.items() if np.abs(g.numpy()).max() > 0}
    assert ("proposal_networks_0" in reached) == updated
    assert not any(np.abs(g.numpy()).max() for n, g in want.items() if "jacobian_head" in n)

    _check_params_after_adam(state.model, v["params"], ref["new"].params)
    _check_stats(state.model, ref["new"].batch_stats)


def test_second_train_step_from_carried_optax_state(steps):
    """The JAX state after one update step (parameters, BatchNorm statistics,
    the optax Adam moments and count) carried over to the port, then one more
    step on both sides."""
    from neural_jacobian_field_torch.training import train_step
    from neural_jacobian_field_torch.utils.from_jax import load_optax_adam_state

    ref = steps["second"]
    start = ref["start"]
    state = _port_state(start.params, start.batch_stats)
    adam = [s for s in jax.tree.leaves(start.opt_state,
                                       is_leaf=lambda s: hasattr(s, "mu"))
            if hasattr(s, "mu")]
    load_optax_adam_state(state.optimizer, state.model, *adam)
    state.step, state.steps_since_update = int(start.step), int(start.steps_since_update)
    yx, draws = ref["draws"]
    metrics = train_step(state, _port_batch(steps["arrays"]), updated=True, yx=yx,
                         draws=draws)
    _check_metrics(metrics, ref["metrics"])
    _check_params_after_adam(state.model, start.params, ref["new"].params)
    _check_stats(state.model, ref["new"].batch_stats)
