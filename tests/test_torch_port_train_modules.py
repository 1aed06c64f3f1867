"""The training slice's modules against the JAX package, one at a time, on
the same numpy inputs: trunc_exp's clamped gradient, training-mode
BatchNorm, the three rendering losses, batch preparation, the step
schedules, and the optimizer (Adam with decay, warmup, clipping and the
encoder learning-rate scale). Everything is float32 on the CPU; each
tolerance says what separates the two sides.
"""

import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from _torch_port_common import INTRINSICS, jax_model_cfg, look_at_offset, torch_model_cfg


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, tol, rel=True):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    scale = max(np.abs(want).max(), 1e-30) if rel else 1.0
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"err {err:.3e} > {tol:.1e}"


# ------------------------------------------------------------------ trunc_exp

def test_trunc_exp_gradient_matches_jax():
    """Forward exp(x); gradient exp(clamp(x, -15, 15)), also beyond |x| = 15
    (float32 exp on both sides: 1e-6 relative)."""
    from neural_jacobian_field_tpu.ops.activations import trunc_exp as j_trunc_exp
    from neural_jacobian_field_torch.ops.activations import trunc_exp

    x = np.array([-40.0, -15.5, -15.0, -3.0, 0.0, 2.5, 14.9, 15.0, 20.0, 100.0], np.float32)
    g = np.linspace(0.5, 1.5, x.size).astype(np.float32)
    y, vjp = jax.vjp(j_trunc_exp, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    tx = _t(x).requires_grad_()
    ty = trunc_exp(tx)
    (got,) = torch.autograd.grad(ty, tx, _t(g))
    np.testing.assert_allclose(_np(ty), np.asarray(y), rtol=1e-6)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)
    assert math.isinf(float(ty[-1].detach())) and math.isfinite(float(got[-1]))
    np.testing.assert_allclose(float(got[-1]), float(g[-1]) * math.exp(15.0), rtol=1e-6)


# ------------------------------------------------------------------ BatchNorm

def test_train_mode_batchnorm_matches_flax():
    """Output, gradients (input, scale, bias) and the updated running
    statistics against flax.linen.BatchNorm(momentum=0.9) in training mode:
    the biased batch variance in float32 on both sides, 1e-5 of scale."""
    from neural_jacobian_field_torch.models.encoder_resnet import BatchNorm

    rng = np.random.default_rng(0)
    b, h, w, c = 3, 5, 6, 8
    x = (2.0 + 1.5 * rng.normal(size=(b, h, w, c))).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    scale = (1.0 + 0.1 * rng.normal(size=c)).astype(np.float32)
    bias = (0.1 * rng.normal(size=c)).astype(np.float32)
    mean0 = (0.1 * rng.normal(size=c)).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, size=c).astype(np.float32)

    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}

    def f(xx, p):
        return bn.apply({"params": p, "batch_stats": stats}, xx, mutable=["batch_stats"])

    y, new_vars = f(jnp.asarray(x), params)
    _, vjp = jax.vjp(lambda xx, p: f(xx, p)[0], jnp.asarray(x), params)
    want_dx, want_dp = vjp(jnp.asarray(g))

    tbn = BatchNorm(c)
    with torch.no_grad():
        tbn.weight.copy_(_t(scale))
        tbn.bias.copy_(_t(bias))
        tbn.running_mean.copy_(_t(mean0))
        tbn.running_var.copy_(_t(var0))
    tx = _t(x).requires_grad_()
    ty = tbn(tx, train=True)
    ty.backward(_t(g))
    _close(_np(ty), y, 1e-5)
    _close(_np(tx.grad), want_dx, 1e-5)
    _close(_np(tbn.weight.grad), want_dp["scale"], 1e-5)
    _close(_np(tbn.bias.grad), want_dp["bias"], 1e-5)
    _close(_np(tbn.running_mean), new_vars["batch_stats"]["mean"], 1e-6)
    _close(_np(tbn.running_var), new_vars["batch_stats"]["var"], 1e-6)
    # biased variance: the running update is not torch's unbiased one
    bvar = x.reshape(-1, c).var(0)
    _close(_np(tbn.running_var), 0.9 * var0 + 0.1 * bvar, 1e-5)
    # eval mode reads the running statistics and leaves them alone
    before = tbn.running_mean.clone()
    want_eval = fnn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5).apply(
        {"params": params, "batch_stats": new_vars["batch_stats"]}, jnp.asarray(x))
    with torch.no_grad():
        _close(_np(tbn(_t(x))), want_eval, 1e-5)
    assert torch.equal(tbn.running_mean, before)


# --------------------------------------------------------------------- losses

def _loss_inputs(seed=1, b=2, r=5, s0=6, s1=7):
    rng = np.random.default_rng(seed)

    def edges(s):
        e = np.sort(rng.uniform(size=(b, r, s + 1)), axis=-1)
        e[..., 0], e[..., -1] = 0.0, 1.0
        return e.astype(np.float32)

    def weights(s):
        w = rng.uniform(size=(b, r, s, 1))
        return (w / w.sum(-2, keepdims=True) * 0.9).astype(np.float32)

    sd = [edges(s0), edges(s1)]
    wl = [weights(s0), weights(s1)]
    tdist = [0.5 + 3.5 * e for e in sd]
    depth = rng.uniform(0.6, 3.9, size=(b, r, 1)).astype(np.float32)
    depth[0, :2] = 0.0  # invalid depths are masked out
    return sd, wl, tdist, depth


def test_interlevel_and_distortion_losses_match_jax():
    """Values and gradients (proposal weights for interlevel; final weights
    and edges for distortion): float32, 1e-5 of scale. The port looks the
    envelope up with searchsorted + gather where JAX uses a one-hot
    compare-reduce; the selected indices are the same."""
    from neural_jacobian_field_tpu.ops import losses as jl
    from neural_jacobian_field_torch.ops import losses as tl

    sd, wl, _, _ = _loss_inputs()
    want, vjp = jax.vjp(lambda w0: jl.interlevel_loss([jnp.asarray(s) for s in sd],
                                                      [w0, jnp.asarray(wl[1])]),
                        jnp.asarray(wl[0]))
    (want_g,) = vjp(jnp.ones_like(want))
    w0 = _t(wl[0]).requires_grad_()
    got = tl.interlevel_loss([_t(s) for s in sd], [w0, _t(wl[1])])
    got.backward()
    assert float(want) > 0
    _close(_np(got), want, 1e-5)
    _close(_np(w0.grad), want_g, 1e-5)

    want, vjp = jax.vjp(lambda s, w: jl.distortion_loss([jnp.asarray(sd[0]), s],
                                                        [jnp.asarray(wl[0]), w]),
                        jnp.asarray(sd[1]), jnp.asarray(wl[1]))
    want_gs, want_gw = vjp(jnp.ones_like(want))
    s1, w1 = _t(sd[1]).requires_grad_(), _t(wl[1]).requires_grad_()
    got = tl.distortion_loss([_t(sd[0]), s1], [_t(wl[0]), w1])
    got.backward()
    _close(_np(got), want, 1e-5)
    _close(_np(s1.grad), want_gs, 1e-5)
    _close(_np(w1.grad), want_gw, 1e-5)


def test_ds_nerf_depth_loss_matches_jax():
    """Value and weight gradient with some invalid (zero) depths: 1e-5."""
    from neural_jacobian_field_tpu.ops import losses as jl
    from neural_jacobian_field_torch.ops import losses as tl

    _, wl, tdist, depth = _loss_inputs(seed=2)
    t = tdist[1]
    steps = ((t[..., :-1] + t[..., 1:]) / 2)[..., None]
    lengths = (t[..., 1:] - t[..., :-1])[..., None]
    # a sigma wide enough that every valid ray's samples carry weight
    want, vjp = jax.vjp(lambda w: jl.ds_nerf_depth_loss(w, jnp.asarray(depth),
                                                        jnp.asarray(steps),
                                                        jnp.asarray(lengths), 0.5),
                        jnp.asarray(wl[1]))
    (want_g,) = vjp(jnp.ones_like(want))
    w = _t(wl[1]).requires_grad_()
    got = tl.ds_nerf_depth_loss(w, _t(depth), _t(steps), _t(lengths), 0.5)
    got.backward()
    assert float(want) > 0
    _close(_np(got), want, 1e-5)
    _close(_np(w.grad), want_g, 1e-5)
    assert float(w.grad[0, :2].abs().max()) == 0.0


# -------------------------------------------------------------------- prepare

def _raw_batch_arrays(seed=3, b=2, h=12, w=16):
    rng = np.random.default_rng(seed)
    trgt = np.stack([look_at_offset(10.0), look_at_offset(-6.0)])[:b]
    return dict(
        ctxt_rgb=rng.integers(0, 256, size=(b, h, w, 3), dtype=np.uint8),
        ctxt_extrinsics=np.broadcast_to(np.eye(4, dtype=np.float32), (b, 4, 4)).copy(),
        ctxt_intrinsics=np.broadcast_to(INTRINSICS, (b, 3, 3)).copy(),
        robot_action=rng.normal(size=(b, 4)).astype(np.float32),
        trgt_rgb=rng.integers(0, 256, size=(b, h, w, 3), dtype=np.uint8),
        trgt_depth=rng.uniform(1.0, 4.0, size=(b, h, w, 1)).astype(np.float32),
        trgt_extrinsics=trgt.astype(np.float32),
        trgt_intrinsics=np.broadcast_to(INTRINSICS, (b, 3, 3)).copy(),
        near=np.full((b,), 0.5, np.float32), far=np.full((b,), 4.0, np.float32))


def test_prepare_training_batch_matches_jax():
    """uint8 RGB, one pixel set for the whole batch: given JAX's own pixel
    draw, every model input and target agrees to float32 rounding (1e-6)."""
    from neural_jacobian_field_tpu.training import prepare as jp
    from neural_jacobian_field_torch.training import RawBatch, prepare_training_batch

    a = _raw_batch_arrays()
    rays, h, w = 20, 12, 16
    key = jax.random.PRNGKey(5)
    jmi, jmt = jp.prepare_training_batch(key, jp.RawBatch(**{k: jnp.asarray(v)
                                                            for k, v in a.items()}), rays)
    yx = np.array((jax.random.uniform(key, (rays, 2)) * jnp.array([h, w], jnp.float32))
                  .astype(jnp.int32))
    tb = RawBatch(**{k: torch.from_numpy(v) for k, v in a.items()})
    tmi, tmt = prepare_training_batch(tb, rays, yx=torch.from_numpy(yx))
    pairs = [(tmt.rgb, jmt.rgb), (tmt.depth, jmt.depth),
             (tmi.camera_input.input_image, jmi.camera_input.input_image),
             (tmi.camera_input.trgt_intrinsics, jmi.camera_input.trgt_intrinsics),
             (tmi.rendering_input.origins, jmi.rendering_input.origins),
             (tmi.rendering_input.directions, jmi.rendering_input.directions),
             (tmi.rendering_input.z_near, jmi.rendering_input.z_near),
             (tmi.robot_input.robot_action, jmi.robot_input.robot_action)]
    for got, want in pairs:
        _close(_np(got), want, 1e-6)
    # the generator path: a pixel set in range, the same for the same seed
    m1, _ = prepare_training_batch(tb, rays, torch.Generator().manual_seed(0))
    m2, _ = prepare_training_batch(tb, rays, torch.Generator().manual_seed(0))
    assert torch.equal(m1.rendering_input.directions, m2.rendering_input.directions)


# ------------------------------------------------------------------ schedules

def test_step_schedules_match_jax_over_training():
    """anneal, the proposal gate and the update counter over steps 0-12,000
    and every counter value that occurs. The port computes the gate on host
    scalars in float64, as the JAX host mirror `host_step_schedule` (which
    picks the static gate of the JAX train loop) and the reference do: gate
    and counter equal it exactly. The traced JAX schedule divides in float32
    and so differs from its own host mirror where step / warmup * every lands
    on an integer (steps 2000-5000 with the counter at that integer): equal
    to it everywhere else. anneal to float32 rounding."""
    from neural_jacobian_field_tpu.models.model import step_schedules as j_sched
    from neural_jacobian_field_tpu.training.train import host_step_schedule as j_host
    from neural_jacobian_field_torch.models.model import step_schedules
    from neural_jacobian_field_torch.training import host_step_schedule

    jcfg, tcfg = jax_model_cfg().rendering, torch_model_cfg().rendering
    steps = np.arange(0, 12001)
    ssus = np.arange(0, tcfg.proposal_update_every + 3)
    grid_s, grid_u = (g.ravel() for g in np.meshgrid(steps, ssus, indexing="ij"))
    fn = jax.jit(jax.vmap(lambda s, u: j_sched(s, u, jcfg)))
    ja, jupd, jssu = (np.asarray(v) for v in fn(jnp.asarray(grid_s), jnp.asarray(grid_u)))
    got = [step_schedules(int(s), int(u), tcfg) for s, u in zip(grid_s, grid_u)]
    host = [j_host(int(s), int(u), jcfg) for s, u in zip(grid_s, grid_u)]
    np.testing.assert_allclose([a for a, _, _ in got], ja, rtol=1e-6, atol=1e-7)
    assert [(u, n) for _, u, n in got] == host
    assert [host_step_schedule(int(s), int(u), tcfg) for s, u in zip(grid_s, grid_u)] == host
    off = np.flatnonzero(np.array([u for _, u, _ in got]) != jupd)
    assert sorted(zip(grid_s[off].tolist(), grid_u[off].tolist())) == [
        (1000 * k, k) for k in (2, 3, 4, 5)]
    keep = np.setdiff1d(np.arange(grid_s.size), off)
    np.testing.assert_array_equal(np.array([n for _, _, n in got])[keep], jssu[keep])
    assert 0 < np.mean(jupd) < 1
    # the counter carried across a run
    ssu_t = ssu_j = 0
    for s in range(0, 12001, 7):
        upd_t, ssu_t = host_step_schedule(s, ssu_t, tcfg)
        upd_j, ssu_j = j_host(s, ssu_j, jcfg)
        assert (upd_t, ssu_t) == (upd_j, ssu_j)


# ------------------------------------------------------------------ optimizer

class _Tiny(nn.Module):
    """Two parameter groups by name: encoder.* and the rest."""

    def __init__(self):
        super().__init__()
        self.encoder = nn.Module()
        self.encoder.conv = nn.Linear(3, 4)
        self.decoder = nn.Module()
        self.decoder.head = nn.Linear(4, 2)
        self.decoder.unused = nn.Linear(2, 2)


def _tiny_jax_params(rng):
    def lin(i, o):
        return {"kernel": (rng.normal(size=(i, o)) / math.sqrt(i)).astype(np.float32),
                "bias": (0.1 * rng.normal(size=(o,))).astype(np.float32)}

    return {"encoder": {"conv": lin(3, 4)},
            "decoder": {"head": lin(4, 2), "unused": lin(2, 2)}}


@pytest.mark.parametrize("clip,enc_scale", [(None, 1.0), (0.5, 0.1)])
def test_optimizer_matches_optax_over_three_updates(clip, enc_scale):
    """Adam(wd 1e-5) with the warmup schedule, global-norm clipping and the
    encoder lr scale, against the JAX package's optax chain over 3 updates
    of seeded gradients. decoder.unused never gets a gradient: optax still
    decays and normalises its zeros, so it must move the same way here.
    Each parameter's displacement agrees to 2e-5 of its largest entry:
    optax takes the bias correction 1 - 0.999^t in float32 (1.3e-5 off at
    t = 1, 6.4e-6 in its square root), torch in float64."""
    from neural_jacobian_field_tpu.training.train import TrainCfg as JCfg
    from neural_jacobian_field_tpu.training.train import make_optimizer as j_make
    from neural_jacobian_field_torch.training import TrainCfg, TrainState, apply_gradients
    from neural_jacobian_field_torch.training.train import make_optimizer
    from neural_jacobian_field_torch.utils.from_jax import from_jax_variables

    import optax

    rng = np.random.default_rng(7)
    params = _tiny_jax_params(rng)
    kw = dict(lr=1e-2, warm_up_steps=4, grad_clip_norm=clip, encoder_lr_scale=enc_scale)
    tx = j_make(JCfg(**kw), params)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jparams)

    model = _Tiny()
    model.load_state_dict(from_jax_variables(params), strict=True)
    cfg = TrainCfg(**kw)
    state = TrainState(model=model, optimizer=make_optimizer(cfg, model), cfg=cfg)
    for _ in range(3):
        grads = jax.tree.map(lambda p: (3.0 * rng.normal(size=p.shape)).astype(np.float32),
                             params)
        grads["decoder"]["unused"] = jax.tree.map(np.zeros_like, grads["decoder"]["unused"])
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tgrads = from_jax_variables(grads)
        model.zero_grad(set_to_none=True)
        for name, p in model.named_parameters():
            if not name.startswith("decoder.unused"):
                p.grad = tgrads[name].clone()
        apply_gradients(state)
    assert state.step == 3
    want = from_jax_variables(jax.tree.map(np.asarray, jparams))
    start = from_jax_variables(params)
    for name, p in model.named_parameters():
        _close(_np(p) - start[name].numpy(), want[name].numpy() - start[name].numpy(), 2e-5)
    moved = _np(model.decoder.unused.weight) - params["decoder"]["unused"]["kernel"].T
    assert np.abs(moved).min() > 0
