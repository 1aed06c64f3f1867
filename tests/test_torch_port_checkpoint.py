"""The port's checkpoints (training/checkpoint.py, on torch.save/torch.load):
a full train-state round trip, `max_to_keep`, and the shape-tolerant
parameter-only warm start. CPU only, the small model of
tests/_torch_port_common.py.
"""

import numpy as np
import pytest
import torch

from _torch_port_common import INTRINSICS, look_at_offset, torch_model_cfg

RAYS = 8


def _state(seed):
    from neural_jacobian_field_torch.models.model import Model
    from neural_jacobian_field_torch.training import TrainCfg, create_train_state

    model = Model(torch_model_cfg()).init_weights(torch.Generator().manual_seed(seed))
    return create_train_state(model, TrainCfg(lr=1e-3, warm_up_steps=2, rays_per_batch=RAYS))


def _batch():
    from neural_jacobian_field_torch.training import RawBatch

    rng = np.random.default_rng(0)
    b, h, w = 1, 32, 48
    t = torch.from_numpy
    return RawBatch(
        ctxt_rgb=t(rng.uniform(size=(b, h, w, 3)).astype(np.float32)),
        ctxt_extrinsics=torch.eye(4)[None], ctxt_intrinsics=t(INTRINSICS)[None],
        robot_action=t(rng.normal(size=(b, 4)).astype(np.float32)),
        trgt_rgb=t(rng.uniform(size=(b, h, w, 3)).astype(np.float32)),
        trgt_depth=t(rng.uniform(1.0, 3.0, size=(b, h, w, 1)).astype(np.float32)),
        trgt_extrinsics=t(look_at_offset(10.0))[None], trgt_intrinsics=t(INTRINSICS)[None],
        near=torch.full((b,), 0.5), far=torch.full((b,), 4.0))


def _step(state, seed):
    from neural_jacobian_field_torch.training import train_step

    return train_step(state, _batch(), torch.Generator().manual_seed(seed), updated=True)


def test_checkpoint_round_trip_restores_the_whole_train_state(tmp_path):
    """Parameters, BatchNorm statistics, Adam moments, step and the proposal
    counter come back exactly, and the restored state takes the same next
    step as the original."""
    from neural_jacobian_field_torch.training import CheckpointManager

    state = _state(0)
    _step(state, 1)
    _step(state, 2)
    state.steps_since_update = 3
    mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=3, save_interval_steps=2)
    assert mgr.maybe_save(state) and mgr.latest_step() == 2

    other = _state(5)
    mgr.restore(other)
    assert (other.step, other.steps_since_update) == (2, 3)
    for (k, a), (_, b) in zip(state.model.state_dict().items(),
                              other.model.state_dict().items()):
        assert torch.equal(a, b), k
    for p, q in zip(state.model.parameters(), other.model.parameters()):
        sa, sb = state.optimizer.state[p], other.optimizer.state[q]
        assert all(torch.equal(sa[k], sb[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
    _step(state, 3)
    _step(other, 3)
    for (k, a), (_, b) in zip(state.model.state_dict().items(),
                              other.model.state_dict().items()):
        assert torch.equal(a, b), k


def test_checkpoint_manager_keeps_the_last_max_to_keep(tmp_path):
    from neural_jacobian_field_torch.training import CheckpointManager

    state = _state(0)
    mgr = CheckpointManager(tmp_path, max_to_keep=2, save_interval_steps=2)
    saved = []
    for step in range(1, 8):
        state.step = step
        saved.append(mgr.maybe_save(state))
    assert saved == [False, True, False, True, False, True, False]
    assert mgr.latest_step() == 6
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_000000004.pt", "ckpt_000000006.pt"]


def test_load_params_only_reports_shape_mismatch_and_missing_keys(tmp_path):
    """A checkpoint with one parameter of another shape and one missing: the
    other parameters (and, through load_batch_stats, the BatchNorm
    statistics) are restored, those two keep the model's values, and the
    report names both."""
    from neural_jacobian_field_torch.training import (
        CheckpointManager, load_batch_stats, load_params_only)

    src = _state(0)
    _step(src, 1)
    mgr = CheckpointManager(tmp_path, save_interval_steps=1)
    mgr.maybe_save(src)
    path = tmp_path / "ckpt_000000001.pt"
    ckpt = torch.load(path, weights_only=True)
    bad, gone = "decoder.density_head.lin_out.weight", "encoder.bn1.bias"
    ckpt["model"][bad] = torch.zeros(3, 3)
    del ckpt["model"][gone]
    torch.save(ckpt, path)

    dst = _state(7)
    keep = {k: v.clone() for k, v in dst.model.state_dict().items()}
    report = []
    load_params_only(tmp_path, dst.model, report=report)
    reasons = dict(report)
    assert set(reasons) == {bad, gone}
    assert "shape mismatch" in reasons[bad] and "missing" in reasons[gone]
    params = dict(dst.model.named_parameters())
    for k, v in src.model.named_parameters():
        want = keep[k] if k in (bad, gone) else v
        assert torch.equal(params[k], want), k
    # parameters only: the BatchNorm statistics are still the model's own
    stat = "encoder.bn1.running_var"
    assert torch.equal(dst.model.state_dict()[stat], keep[stat])
    load_batch_stats(tmp_path, dst.model)
    assert torch.equal(dst.model.state_dict()[stat], src.model.state_dict()[stat])
    assert not torch.equal(keep[stat], src.model.state_dict()[stat])


def test_restore_from_an_empty_directory_raises(tmp_path):
    from neural_jacobian_field_torch.training import CheckpointManager

    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path).restore(_state(0))
