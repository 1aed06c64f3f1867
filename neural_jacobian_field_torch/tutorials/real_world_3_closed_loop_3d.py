"""Real world 3: closed-loop 3D control through a trained Jacobian field
(the port's counterpart of examples/real_world_3_closed_loop_3d.py; the
reference's notebooks real_world/2 and tutorial 3 lifted to 3D): observe
the robot with one camera, encode the scene once per step
(`Model.encode_image` caches density and Jacobian), compute the desired
pixel motion of tracked points toward a target, solve the action by least
squares, apply it to the (synthetic, analytic sphere) robot, repeat.

It needs an action-stage checkpoint directory that the port wrote, of
`model_cfg(samples)`, on the synthetic scene, e.g.:

  python -m neural_jacobian_field_torch.train dataset.root=<scene> ...      # stage 1
  python -m neural_jacobian_field_torch.train dataset.mode=action ...       # stage 2
  python -m neural_jacobian_field_torch.tutorials.real_world_3_closed_loop_3d \\
      --scene <scene> --ckpt <checkpoint dir> [--iters 12] [--device cpu]

The loop converges only with a trained model: it prints the error per
iteration.
"""

import argparse
import json
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..data import DatasetCfgCommon, get_dataset
from ..data import conventions as cv
from ..data.synthetic import _project, _render_sphere, sphere_center
from ..inference.action_opt import solve_actions_least_squares
from ..models.encoder_resnet import EncoderResnetCfg
from ..models.model import (CameraInput, Model, RenderingCfg, RenderingInput, RobotInput,
                            make_model_cfg)
from ..rendering.geometry import get_pixel_coordinates, get_world_rays
from ..training.checkpoint import load_batch_stats, load_params_only
from ..utils.device import resolve_device

Q_START = (-0.6, 0.5, -0.3)
Q_TARGET = (0.55, -0.45, 0.4)


def model_cfg(samples: int = 64):
    """The example's model: jacobian_mlp over 3 joints, the group-norm
    ResNet-34 encoder, `samples` + `samples` samples (run in bf16)."""
    return make_model_cfg(
        "jacobian_mlp", action_dim=3,
        rendering=RenderingCfg(num_proposal_samples=(samples,), num_nerf_samples=samples),
        encoder=EncoderResnetCfg(norm_type="group"))


def main(argv=None) -> dict:
    tmp = Path(tempfile.gettempdir())
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default=str(tmp / "njf_cli_scene"))
    ap.add_argument("--ckpt", default=str(tmp / "njf_ckpt_long_action"))
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--gain", type=float, default=0.8)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, "the example")

    # the dataset gives the calibrated camera in the model's (oriented,
    # scaled, context-relative) world frame; the "robot" is the analytic sphere
    ds = get_dataset(DatasetCfgCommon(name="allegro", mode="perception", root=args.scene,
                                      num_total_joints=3), "train")
    cam_idx = 0
    c2w_model = torch.eye(4, device=dev)[None]  # the context frame is the identity
    intr_norm, (h, w) = ds.load_intrinsics(cam_idx)

    # the raw (unoriented) camera that synthesises the observations
    meta = json.loads((Path(args.scene) / "transforms.json").read_text())
    cam = meta["cameras"][cam_idx]
    c2w_gl = np.asarray(cam["transform_matrix"], np.float32)
    fx, fy, cx, cy = cam["fl_x"], cam["fl_y"], cam["cx"], cam["cy"]

    model = Model(model_cfg(args.samples), compute_dtype=torch.bfloat16)
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(dev)
    load_params_only(args.ckpt, model)
    if model.cfg.encoder.norm_type == "batch":  # the running statistics
        load_batch_stats(args.ckpt, model)

    span = ds.qpos_maximum - ds.qpos_minimum
    q, q_target = np.array(Q_START), np.array(Q_TARGET)
    coords_all, _ = get_pixel_coordinates(h, w, device=dev)
    intr = torch.as_tensor(np.asarray(intr_norm, np.float32), device=dev)[None]
    intr_px = torch.as_tensor(cv.denormalize_intrinsics(intr_norm, h, w), device=dev)[None]
    near = torch.tensor([float(ds.near)], device=dev)
    far = torch.tensor([float(ds.far)], device=dev)

    print(f"target qpos: {q_target.round(3)}")
    errors = []
    for it in range(args.iters):
        rgb, _, points, hit = _render_sphere(c2w_gl, fx, fy, cx, cy, h, w, sphere_center(q))
        # track pixels on the robot
        ys, xs = np.nonzero(hit)
        sel = np.random.default_rng(it).permutation(len(ys))[:64]
        ys, xs = ys[sel], xs[sel]

        # desired pixel motion: where each tracked surface point would land
        # if the sphere were at the target (a rigid translation)
        p_now = points[ys, xs]
        delta = sphere_center(q_target) - sphere_center(q)
        uv_now = _project(p_now, c2w_gl, fx, fy, cx, cy)
        uv_want = _project(p_now + delta, c2w_gl, fx, fy, cx, cy)
        desired = torch.as_tensor((uv_want - uv_now).astype(np.float32), device=dev)[None]

        # rays through the tracked pixels (normalised camera, context frame)
        coords = coords_all[torch.as_tensor(ys, device=dev), torch.as_tensor(xs, device=dev)]
        origins, directions = get_world_rays(coords[None], intr, c2w_model)
        camera_input = CameraInput(
            input_image=torch.as_tensor(rgb, device=dev)[None], ctxt_extrinsics=c2w_model,
            ctxt_intrinsics=intr, trgt_extrinsics=c2w_model, trgt_intrinsics=intr_px)
        ri = RenderingInput(origins=origins, directions=directions, z_near=near, z_far=far)
        enc = model.encode_image(camera_input, ri, RobotInput(torch.zeros((1, 3), device=dev)))
        a = solve_actions_least_squares(model, enc, camera_input, desired, damping=1e-3)
        # normalised action -> raw joint delta (dq = a * span)
        a = a[0].float().cpu().numpy()
        q = np.clip(q + a * span * args.gain, -1.0, 1.0)
        err = float(np.abs(q - q_target).max())
        errors.append(err)
        print(f"iter {it:2d}: action={a.round(3)}  qpos={q.round(3)}  max err={err:.3f}")
        if err < 0.05:
            print("reached target configuration")
            break
    return dict(errors=errors, qpos=q)


if __name__ == "__main__":
    main()
