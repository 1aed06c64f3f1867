"""Stage 2 (action) of the transformer-decoder model against the JAX package:
the trainable mask of each decoder, and one whole stage-2 train step in
float32 on the CPU.

The small model of tests/test_torch_port_decoders.py (epipolar features,
the transformer decoder at dim 16, 2 heads of 8, depth 2), flow supervision
at 16 shared rays, from the same seeded state on both sides, the port handed
the JAX step's own randomness, as tests/test_torch_port_action.py does for
the Jacobian-MLP decoder. Stage 2 trains every decoder parameter whose name
holds "jacobian": the index embedding, the query MLP, the transformer and
the Dense head.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import randomize_variables, scene_arrays
from neural_jacobian_field_torch.utils.from_jax import from_jax_variables
from test_torch_port_action import (
    LR, RAYS, TOL, WARMUP, _batch_arrays, _jax_batch, _jax_draws, _port_batch, _rel)
from test_torch_port_decoders import DECODER_NAMES, _decoder_cfgs, _inputs


@pytest.mark.parametrize("name", DECODER_NAMES)
def test_trainable_mask_labels_as_jax(name):
    """Stage 2's labels of every parameter, through the bridge, as JAX's
    optax mask for each decoder (with the arm heads): the Jacobian head's,
    the "jacobian" parameters' or the flow heads'."""
    from neural_jacobian_field_tpu.models import model as jm
    from neural_jacobian_field_tpu.training import train as jt
    from neural_jacobian_field_torch.models import model as tm
    from neural_jacobian_field_torch.training import trainable_mask

    jcfg, tcfg = _decoder_cfgs(name, arm=True)
    jmi, _ = _inputs(jm, tm, scene_arrays())
    ctx = jm.StepCtx(key=jax.random.PRNGKey(0), anneal=jnp.asarray(1.0),
                     updated=jnp.asarray(True))
    shapes = jax.eval_shape(jm.Model(cfg=jcfg).init, jax.random.PRNGKey(0), jmi, ctx)
    labels = jt.trainable_mask(shapes["params"], "action", jcfg.action_decoder)
    ones = jax.tree.map(lambda s, lab: np.full(s.shape, float(lab == "trainable"), np.float32),
                        shapes["params"], labels)
    want = {k: bool(v.numpy().all()) for k, v in from_jax_variables(ones).items()}
    model = tm.Model(tcfg)
    got = trainable_mask(model, "action", tcfg.action_decoder)
    assert {k: v == "trainable" for k, v in got.items()} == want
    trained = sorted(k for k, v in want.items() if v)
    pattern = {"jacobian_mlp": "jacobian_head", "jacobian_transformer": "jacobian",
               "flow_mlp": "flow_head"}[name]
    assert trained and all(k.startswith("decoder.") and pattern in k for k in trained)
    if name == "jacobian_transformer":
        assert {k.split(".")[1] for k in trained} == {
            "jacobian_index_embedding", "jacobian_query_mlp", "jacobian_attn_decoder",
            "jacobian_head", "jacobian_head_arm"}


@pytest.fixture(scope="module")
def transformer_step():
    """The JAX stage-2 step (make_train_step, the proposal gate static) of the
    transformer model from a seeded state, its trainable gradients, and the
    step's draws."""
    from neural_jacobian_field_tpu.models import model as jm
    from neural_jacobian_field_tpu.training import prepare as jp
    from neural_jacobian_field_tpu.training import train as jt
    from neural_jacobian_field_tpu.training.losses import action_loss as j_action_loss

    jcfg, tcfg = _decoder_cfgs("jacobian_transformer")
    never = dict(proposal_weights_anneal_max_num_iters=10 ** 9)
    jcfg = dataclasses.replace(jcfg, rendering=dataclasses.replace(jcfg.rendering, **never))
    tcfg = dataclasses.replace(tcfg, rendering=dataclasses.replace(tcfg.rendering, **never),
                               encoder=dataclasses.replace(tcfg.encoder,
                                                           conv_impl="pallas_fused"))
    arrays = _batch_arrays("flow")
    jbatch = _jax_batch(arrays)
    jmodel = jm.Model(cfg=jcfg)
    tcfg_train = jt.TrainCfg(mode="action", lr=LR, warm_up_steps=WARMUP, rays_per_batch=RAYS)
    st = jt.create_train_state(jax.random.PRNGKey(0), jmodel, jbatch, tcfg_train)
    variables = randomize_variables({"params": jax.tree.map(np.asarray, st.params),
                                     "batch_stats": jax.tree.map(np.asarray, st.batch_stats)})
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    tx = jt.make_optimizer(tcfg_train, params, jmodel.cfg.action_decoder)
    st = st.replace(params=params, batch_stats=stats, opt_state=tx.init(params))
    rcfg = jmodel.cfg.rendering
    key = jax.random.PRNGKey(21)
    new, metrics = jt.make_train_step(jmodel, tcfg_train, donate=False,
                                      static_updated=True)(st, jbatch, key)

    @jax.jit
    def grads(p):
        k_prep, k_samp = jax.random.split(key)
        anneal = jm.step_schedules(jnp.asarray(0), jnp.asarray(0), rcfg)[0]
        mi, mt = jp.prepare_training_batch(k_prep, jbatch, RAYS, mode="action")
        ctx = jm.StepCtx(key=k_samp, anneal=anneal, updated=True)

        def loss_fn(pp):
            o, _ = jmodel.apply({"params": jt.stop_frozen_gradients(
                pp, "action", jmodel.cfg.action_decoder), "batch_stats": stats}, mi, ctx,
                train=True, mutable=["batch_stats"])
            return j_action_loss(o, mt, tcfg_train.loss)[0]

        return jax.grad(loss_fn)(p)

    samples = (*rcfg.num_proposal_samples, rcfg.num_nerf_samples)
    return dict(tcfg=tcfg, arrays=arrays, variables=variables, new=new, metrics=metrics,
                grads=grads(params), draws=_jax_draws(key, arrays, samples))


def test_transformer_action_step_matches_jax(transformer_step):
    """One port stage-2 step from the same state with JAX's draws: the flow
    loss (5e-3), the "jacobian" parameters' gradients (5e-3 of scale), no
    gradient elsewhere, their Adam step on the lr scale (at most 1% of a
    tensor's elements further apart than 1e-2 lr, none beyond 2 lr, as the
    stage-2 test of the Jacobian-MLP decoder), every other parameter bit for
    bit unchanged, and the BatchNorm running statistics moved as JAX's."""
    from neural_jacobian_field_torch.models.model import Model
    from neural_jacobian_field_torch.training import TrainCfg, create_train_state, train_step

    ref = transformer_step
    v = ref["variables"]
    model = Model(ref["tcfg"])
    model.load_state_dict(from_jax_variables(v["params"], v["batch_stats"]), strict=True)
    state = create_train_state(model, TrainCfg(mode="action", lr=LR, warm_up_steps=WARMUP,
                                               rays_per_batch=RAYS))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    yx, draws = ref["draws"]
    metrics = train_step(state, _port_batch(ref["arrays"]), updated=True, yx=yx, draws=draws)
    assert set(metrics) == set(ref["metrics"]) == {"loss/flow", "loss/total"}
    for k, w in ref["metrics"].items():
        assert abs(float(metrics[k]) - float(w)) <= TOL * abs(float(w)), k
    grads = from_jax_variables(jax.tree.map(np.asarray, ref["grads"]))
    new = from_jax_variables(jax.tree.map(np.asarray, ref["new"].params))
    trained = 0
    for name, p in model.named_parameters():
        if not (name.startswith("decoder.") and "jacobian" in name):
            assert not p.requires_grad and p.grad is None, name
            assert torch.equal(p.detach(), before[name]), name
            continue
        trained += 1
        assert _rel(p.grad.numpy(), grads[name].numpy()) <= TOL, name
        d_got = p.detach().numpy() - before[name].numpy()
        d_want = new[name].numpy() - before[name].numpy()
        err = np.abs(d_got - d_want) / LR
        assert np.abs(d_want).max() > 0, name
        far = int((err > 1e-2).sum())
        assert far <= max(1, err.size // 100) and err.max() <= 2.0 + 1e-3, (name, far, err.max())
    assert trained == 3 + 12 * 2 + 2  # embedding, query MLP; 12 tensors a layer; head
    stats = from_jax_variables({}, jax.tree.map(np.asarray, ref["new"].batch_stats))
    bufs = dict(model.named_buffers())
    for name, val in stats.items():
        assert _rel(bufs[name].numpy(), val.numpy()) <= 1e-5, name
