"""End-to-end drive of the port on its public surface (counterpart of the
repo's e2e verify script for the JAX package):

    python -m neural_jacobian_field_torch.verify_e2e [--device cpu] [--bf16]
        [--stage1-steps 30] [--stage2-steps 120] [override ...]

A synthetic scene (3 cameras x 3 trajectories x 4 frames, 48x64, action_dim
4); stage 1 (the rgb loss improves over 30 steps at lr 5e-4); stage 2 (warm
start from stage 1, lr 1e-4, the loss descends from its transient peak
over 120 steps on one fixed cycle of batches); the freezing check (every
parameter outside decoder.jacobian_head bit for bit unchanged); inverse
dynamics (Adam on the action against a flow the model realises with a
known action: relative flow residual < 2%); and a short stage-1 leg with
the stabilisers (global-norm clip 1.0, encoder lr x 0.3). The overrides
are the JAX script's (a 2-layer BatchNorm encoder, so the concat feature
layout; 8 + 8 samples); extra dotted overrides follow them, and --bf16 adds
training.compute_dtype=bfloat16 (the fused trunks then run, on the card
through K7 with one 128-wide latent level). `random` and `np.random` are
seeded first: the datasets draw their frame pairs from them. Each check
raises AssertionError; on success the last line is "E2E VERIFY: ALL OK".
"""

import argparse
import random
import sys
import tempfile
from dataclasses import replace

import numpy as np
import torch

from .config import CONFIG_DIR, get_typed_root_config, load_config
from .data import collate, get_dataset, make_synthetic_scene
from .inference.action_opt import optimize_actions
from .models.model import Model, RobotInput
from .parallel import to_device
from .train import resolve_device
from .training import (TrainCfg, create_train_state, make_train_step,
                       prepare_training_batch, trainable_mask)

OVERRIDES = (
    "dataset.num_total_joints=4",
    "dataset.disabled_joints=null",
    "dataset.max_num_frames_per_traj=4",
    "model.action_dim=4",
    "model.rendering.num_proposal_samples=[8]",
    "model.rendering.num_nerf_samples=8",
    "model.encoder.num_layers=2",
    "model.encoder.norm_type=batch",
)


def run(device=None, overrides=(), stage1_steps: int = 30, stage2_steps: int = 120,
        solve_iters: int = 100, stabilizer_steps: int = 8, root=None, log=print) -> dict:
    """The drive; returns its curves and checks: stage-1 rgb and stage-2
    total losses per step, the frozen and moved parameter counts, the flow
    residual. Raises AssertionError where a check fails."""
    random.seed(0)
    np.random.seed(0)
    dev = resolve_device(device)
    root = root or tempfile.mkdtemp(prefix="njf_scene_")
    make_synthetic_scene(root, num_cameras=3, num_trajs=3, frames_per_traj=4,
                         height=48, width=64, action_dim=4)
    log(f"scene: {root}")
    cfg = get_typed_root_config(load_config(
        CONFIG_DIR, [f"dataset.root={root}", *OVERRIDES, *overrides]))
    dtype = torch.bfloat16 if cfg.training.compute_dtype == "bfloat16" else None

    def new_model(seed):
        model = Model(cfg=cfg.model, compute_dtype=dtype)
        return model.init_weights(torch.Generator().manual_seed(seed)).to(dev)

    def batch_of(ds, idxs):
        return to_device(collate([ds[i] for i in idxs]), dev)

    g = torch.Generator(device=dev).manual_seed(0)
    out = {}

    # ---- stage 1: perception
    ds1 = get_dataset(replace(cfg.dataset, mode="perception"), "train")
    tc1 = TrainCfg(mode="perception", rays_per_batch=128, warm_up_steps=100, lr=5e-4)
    model = new_model(0)
    state = create_train_state(model, tc1)
    step1 = make_train_step(model, tc1)
    losses = []
    for i in range(stage1_steps):
        b = batch_of(ds1, [(i * 3 + j) % len(ds1) for j in range(4)])
        losses.append(float(step1(state, b, generator=g)["loss/rgb"]))
    out["stage1_rgb"] = losses
    log(f"stage1 rgb loss: first3={[round(x, 4) for x in losses[:3]]} "
        f"last3={[round(x, 4) for x in losses[-3:]]}")
    assert np.all(np.isfinite(losses)), "stage-1 loss is not finite"
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), "stage-1 rgb loss did not improve"

    # ---- stage 2: action (warm start, fresh optimizer, freezing)
    ds2 = get_dataset(replace(cfg.dataset, mode="action"), "train")
    tc2 = TrainCfg(mode="action", rays_per_batch=128, warm_up_steps=100, lr=1e-4)
    model2 = new_model(1)
    state2 = create_train_state(model2, tc2, init_params=model.state_dict())
    labels = trainable_mask(model2, "action", cfg.model.action_decoder)
    before = {k: p.detach().clone() for k, p in model2.named_parameters()}
    frozen = [k for k, v in labels.items() if v == "frozen"]
    log(f"freezing: {len(frozen)} frozen / {len(labels)} total parameters")
    assert 0 < len(frozen) < len(labels)
    step2 = make_train_step(model2, tc2)
    l2 = []
    for i in range(stage2_steps):
        b = batch_of(ds2, [(i * 3 + j) % len(ds2) for j in range(4)])
        l2.append(float(step2(state2, b, generator=g)["loss/total"]))
    out["stage2_total"] = l2
    peak = max(l2[:20])
    log(f"stage2 loss: first3={[round(x, 5) for x in l2[:3]]} peak20={peak:.5f} "
        f"last3={[round(x, 5) for x in l2[-3:]]}")
    assert np.all(np.isfinite(l2)), "stage-2 loss is not finite"
    assert np.mean(l2[-5:]) < peak, "stage-2 loss did not descend from transient peak"
    after = dict(model2.named_parameters())
    moved_frozen = [k for k in frozen if not torch.equal(before[k], after[k])]
    changed = sum(not torch.equal(before[k], after[k])
                  for k, v in labels.items() if v == "trainable")
    out["frozen"], out["frozen_moved"], out["trainable_moved"] = (len(frozen), moved_frozen,
                                                                  changed)
    assert not moved_frozen, f"frozen parameters moved: {moved_frozen[:4]}"
    log(f"freezing OK: frozen parameters bit-identical; {changed} trainable parameters moved")
    assert changed > 0

    # ---- inverse dynamics off one cached encoding, against a flow the model
    # realises with a known action (a toy-trained Jacobian cannot fit the raw
    # dataset flow, printed for information)
    raw = batch_of(ds2, [0])
    mi, tgt = prepare_training_batch(raw, 512, generator=g, mode="action")
    enc = model2.encode_image(mi.camera_input, mi.rendering_input, mi.robot_input)
    with torch.no_grad():
        target = model2.infer_optical_flow(enc, mi.camera_input,
                                           RobotInput(robot_action=raw.robot_action))
    res = optimize_actions(model2, enc, mi.camera_input, target, generator=g,
                           num_iters=solve_iters, learning_rate=0.1)
    best = res.actions[int(torch.argmin(res.losses))]
    with torch.no_grad():
        pred = model2.infer_optical_flow(enc, mi.camera_input, RobotInput(robot_action=best))
    rel = float(torch.linalg.vector_norm(pred - target)
                / (torch.linalg.vector_norm(target) + 1e-12))
    rel_ds = float(torch.linalg.vector_norm(pred - tgt.optical_flow)
                   / (torch.linalg.vector_norm(tgt.optical_flow) + 1e-12))
    out["flow_residual"] = rel
    log(f"inverse dynamics: relative flow residual = {rel:.4%} (loss {float(res.loss):.3e})")
    log(f"(informational: residual vs raw dataset flow = {rel_ds:.1%} "
        f"at this toy training budget)")
    assert rel < 0.02, f"flow residual {rel} >= 2%"

    # ---- the stabilisers through the same surface (a short leg)
    if stabilizer_steps:
        tcs = TrainCfg(mode="perception", rays_per_batch=128, warm_up_steps=100, lr=5e-4,
                       grad_clip_norm=1.0, encoder_lr_scale=0.3)
        model3 = new_model(7)
        state3 = create_train_state(model3, tcs)
        step3 = make_train_step(model3, tcs)
        ls = []
        for i in range(stabilizer_steps):
            b = batch_of(ds1, [(i * 3 + j) % len(ds1) for j in range(4)])
            ls.append(float(step3(state3, b, generator=g)["loss/rgb"]))
        out["stabilizer_rgb"] = ls
        assert np.isfinite(ls).all(), ls
        log(f"stabilizer leg (clip=1.0, enc_lr x0.3): rgb loss {ls[0]:.4f} -> {ls[-1]:.4f}")
    log("E2E VERIFY: ALL OK")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="cpu, or the card (the default)")
    parser.add_argument("--bf16", action="store_true",
                        help="training.compute_dtype=bfloat16")
    parser.add_argument("--stage1-steps", type=int, default=30)
    parser.add_argument("--stage2-steps", type=int, default=120)
    parser.add_argument("overrides", nargs="*", help="extra dotted overrides")
    args = parser.parse_args(argv)
    overrides = list(args.overrides) + (["training.compute_dtype=bfloat16"] if args.bf16 else [])
    run(args.device, overrides, args.stage1_steps, args.stage2_steps)


if __name__ == "__main__":
    sys.exit(main())
