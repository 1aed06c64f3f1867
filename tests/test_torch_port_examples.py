"""The last gaps of the port against the JAX package, and its real-world
examples, on the CPU: `TrainCfg.log_sanity` (the min and max of every float
tensor of a step's inputs, targets and outputs among its metrics, under
JAX's names), `RaySamples.spacing_to_euclidean`, and the three modules
neural_jacobian_field_torch/tutorials/real_world_*.py (the counterparts of
examples/real_world_*.py) run at small sizes.

The sanity step runs the dry run's shapes (16x16, a 2-stage BatchNorm
encoder, epipolar knots (8, 4, 2), 4 + 4 samples, 16 rays) from the same
seeded weights on both sides with JAX's draws, so the inputs and targets
are the same numbers (1e-6 of scale) and the outputs agree to the field
tolerance of tests/test_torch_port_model.py (5e-3 of scale).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import INTRINSICS, jax_model_cfg, look_at_offset, randomize_variables
from _torch_port_common import torch_model_cfg
from neural_jacobian_field_torch.utils.from_jax import from_jax_variables

HW, RAYS, B = 16, 16, 2


def _cfgs():
    rendering = dict(num_proposal_samples=(4,), num_nerf_samples=4)
    j, t = jax_model_cfg(), torch_model_cfg()
    return (replace(j, rendering=replace(j.rendering, **rendering),
                    encoder=replace(j.encoder, num_layers=2)),
            replace(t, rendering=replace(t.rendering, **rendering),
                    encoder=replace(t.encoder, num_layers=2)))


def _arrays(seed=3):
    rng = np.random.default_rng(seed)
    return dict(
        ctxt_rgb=rng.integers(0, 256, size=(B, HW, HW, 3), dtype=np.uint8),
        ctxt_extrinsics=np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy(),
        ctxt_intrinsics=np.broadcast_to(INTRINSICS, (B, 3, 3)).copy(),
        robot_action=rng.normal(size=(B, 4)).astype(np.float32),
        trgt_rgb=rng.integers(0, 256, size=(B, HW, HW, 3), dtype=np.uint8),
        trgt_depth=rng.uniform(1.0, 3.5, size=(B, HW, HW, 1)).astype(np.float32),
        trgt_extrinsics=np.stack([look_at_offset(10.0), look_at_offset(-8.0)]),
        trgt_intrinsics=np.broadcast_to(INTRINSICS, (B, 3, 3)).copy(),
        near=np.full((B,), 0.5, np.float32), far=np.full((B,), 4.0, np.float32))


def test_log_sanity_matches_jax():
    """One perception step with log_sanity on both sides: the same sanity
    keys (sanity/input_*, sanity/target_*, sanity/output_*), inputs and
    targets to 1e-6 of scale, outputs to 5e-3 of scale; without it, no
    sanity key."""
    from neural_jacobian_field_tpu.models import model as jm
    from neural_jacobian_field_tpu.training import prepare as jp
    from neural_jacobian_field_tpu.training import train as jt
    from neural_jacobian_field_torch.models.model import Model
    from neural_jacobian_field_torch.training import (RawBatch, TrainCfg, create_train_state,
                                                      train_step)

    jcfg, tcfg = _cfgs()
    arrays = _arrays()
    jbatch = jp.RawBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jmodel = jm.Model(cfg=jcfg)
    jtc = jt.TrainCfg(rays_per_batch=RAYS, log_sanity=True)
    shapes = jax.eval_shape(lambda: jt.create_train_state(jax.random.PRNGKey(0), jmodel,
                                                          jbatch, jtc))
    variables = randomize_variables({
        "params": jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes.params),
        "batch_stats": jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes.batch_stats)})
    st = jt.create_train_state(jax.random.PRNGKey(0), jmodel, jbatch, jtc,
                               init_params=jax.tree.map(jnp.asarray, variables["params"]),
                               init_batch_stats=jax.tree.map(jnp.asarray,
                                                             variables["batch_stats"]))
    key = jax.random.PRNGKey(21)
    _, want = jt.make_train_step(jmodel, jtc, donate=False, static_updated=True)(st, jbatch, key)
    k_prep, k_samp = jax.random.split(key)
    yx = jax.random.uniform(k_prep, (RAYS, 2)) * jnp.array([HW, HW], jnp.float32)
    draws = [torch.from_numpy(np.array(jax.random.uniform(k, (B, RAYS, 5))))
             for k in jax.random.split(k_samp, 2)]
    yx = torch.from_numpy(np.array(yx.astype(jnp.int32)))

    got = {}
    for sanity in (True, False):
        model = Model(tcfg)
        model.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"]))
        state = create_train_state(model, TrainCfg(rays_per_batch=RAYS, log_sanity=sanity))
        batch = RawBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()})
        got[sanity] = train_step(state, batch, updated=True, yx=yx, draws=draws)
    assert not any(k.startswith("sanity/") for k in got[False])
    want = {k: float(v) for k, v in want.items() if k.startswith("sanity/")}
    got = {k: float(v) for k, v in got[True].items() if k.startswith("sanity/")}
    assert set(got) == set(want) and len(want) > 20
    for kind, tol in (("input", 1e-6), ("target", 1e-6), ("output", 5e-3)):
        keys = [k for k in want if k.startswith(f"sanity/{kind}_")]
        assert keys, kind
        scale = max(max(abs(want[k]) for k in keys), 1e-6)
        for k in keys:
            assert abs(got[k] - want[k]) <= tol * scale, (k, got[k], want[k])


@pytest.mark.parametrize("spacing", ["uniform", "lin_disp", "piecewise"])
def test_spacing_to_euclidean_matches_jax(spacing):
    """x in [0, 1] between s_near and s_far back to euclidean distance, for
    each spacing function, against JAX's (1e-6 of scale), and the inverse
    of the spacing function at the ends."""
    from neural_jacobian_field_tpu.rendering import samplers as js
    from neural_jacobian_field_torch.rendering import samplers as ts

    rng = np.random.default_rng(0)
    near = rng.uniform(0.2, 1.0, size=(2, 3, 1)).astype(np.float32)
    far = near + rng.uniform(1.0, 6.0, size=(2, 3, 1)).astype(np.float32)
    x = rng.uniform(size=(2, 3, 5, 1)).astype(np.float32)
    x[..., 0, 0], x[..., 1, 0] = 0.0, 1.0
    zero = np.zeros((2, 3, 5, 1), np.float32)

    def fields(mod, arr, s_near, s_far):
        return dict(origins=arr(zero[..., :1, :]), directions=arr(zero[..., :1, :]),
                    starts=arr(zero), ends=arr(zero), deltas=arr(zero),
                    spacing_starts=arr(zero), spacing_ends=arr(zero),
                    s_near=s_near, s_far=s_far, spacing=spacing)

    jn, jf = (js.spacing_fn(spacing, jnp.asarray(v)) for v in (near, far))
    want = np.asarray(js.RaySamples(**fields(js, jnp.asarray, jn[:, :, None], jf[:, :, None]))
                      .spacing_to_euclidean(jnp.asarray(x)))
    tn, tf = (ts.spacing_fn(spacing, torch.from_numpy(v)) for v in (near, far))
    got = ts.RaySamples(**fields(ts, torch.from_numpy, tn[:, :, None], tf[:, :, None])
                        ).spacing_to_euclidean(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    np.testing.assert_allclose(got[..., 0, 0], near[..., 0], rtol=1e-5)
    np.testing.assert_allclose(got[..., 1, 0], far[..., 0], rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_real_world_1_visualize_on_cpu(tmp_path):
    """Two training steps of the example's tiny model on its synthetic
    scene, the 32x48 render of its first batch and the four images."""
    from neural_jacobian_field_torch.tutorials import real_world_1_visualize as rw1

    out = rw1.main(["--steps", "2", "--hw", "32", "48", "--device", "cpu",
                    "--out", str(tmp_path / "vis"),
                    "--scene", str(tmp_path / "scene")])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert out["render"].rgb.shape == (4, 32, 48, 3)
    assert torch.isfinite(out["render"].rgb).all() and torch.isfinite(out["render"].flow_raw).all()
    assert out["sensitivity"].shape[-2:] == (32, 48)
    assert sorted(p.name for p in out["out"].iterdir()) == [
        "depth.png", "flow.png", "rgb.png", "sensitivity.png"]


def test_real_world_2_inverse_dynamics_on_cpu(tmp_path):
    """The example at its defaults: Adam's loss falls over its 100 steps, and
    least squares recovers the action (the target flow is the model's own
    for it)."""
    from neural_jacobian_field_torch.tutorials import real_world_2_inverse_dynamics as rw2

    out = rw2.main(["--device", "cpu", "--scene", str(tmp_path / "scene")])
    losses = out["losses"]
    assert losses.shape == (100,) and float(losses[-1]) < 0.5 * float(losses[0])
    assert torch.allclose(out["least_squares"], out["true_action"], atol=2e-2)


def test_real_world_3_closed_loop_on_a_port_checkpoint(tmp_path, capsys):
    """Two loop iterations from a checkpoint directory the port wrote with
    the example's model config (seeded weights, 8 + 8 samples): finite
    actions and errors each iteration (convergence needs a trained model)."""
    from neural_jacobian_field_torch.data import make_synthetic_scene
    from neural_jacobian_field_torch.models.model import Model
    from neural_jacobian_field_torch.training import (CheckpointManager, TrainCfg,
                                                      create_train_state)
    from neural_jacobian_field_torch.tutorials import real_world_3_closed_loop_3d as rw3

    scene = make_synthetic_scene(tmp_path / "scene", num_cameras=3, num_trajs=2,
                                 frames_per_traj=4, height=32, width=40, action_dim=3)
    model = Model(rw3.model_cfg(8))
    model.init_weights(torch.Generator().manual_seed(1))
    CheckpointManager(tmp_path / "ck", save_interval_steps=1).maybe_save(
        create_train_state(model, TrainCfg(mode="action")))
    out = rw3.main(["--device", "cpu", "--scene", str(scene), "--ckpt", str(tmp_path / "ck"),
                    "--samples", "8", "--iters", "2"])
    assert len(out["errors"]) == 2 and np.isfinite(out["errors"]).all()
    assert "warm start: kept" in capsys.readouterr().out
