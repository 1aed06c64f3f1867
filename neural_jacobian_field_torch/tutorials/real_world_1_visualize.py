"""Real world 1: whole-image rendering and joint-sensitivity maps (the
port's counterpart of examples/real_world_1_visualize.py, the reference's
notebooks/real_world/1_*.ipynb): train a tiny perception model on the
synthetic sphere scene, render rgb / depth / flow of a view with the
chunked renderer, and composite each joint's Jacobian sensitivity over the
image. Point the model at a trained checkpoint for a real robot.

  python -m neural_jacobian_field_torch.tutorials.real_world_1_visualize \\
      [--out DIR] [--scene DIR] [--steps 100] [--hw 48 64] [--device cpu]

It runs on the card unless --device cpu; the scene is written (under the
temporary directory by default) where it does not exist yet.
"""

import argparse
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..data import DataLoader, DatasetCfgCommon, get_dataset, make_synthetic_scene
from ..data.image_io import write_rgb
from ..inference import compute_joint_sensitivity, visualize_joint_sensitivity
from ..inference.render import depth_colormap, flow_to_rgb, render_camera
from ..models.encoder_resnet import EncoderResnetCfg
from ..models.model import Model, RenderingCfg, make_model_cfg
from ..parallel import to_device
from ..training import TrainCfg, create_train_state, make_train_step, prepare_training_batch
from ..utils.device import resolve_device


def model_cfg():
    """The example's model: jacobian_mlp over 3 joints, a 3-stage group-norm
    encoder, 24 + 24 samples."""
    return make_model_cfg(
        "jacobian_mlp", action_dim=3,
        rendering=RenderingCfg(num_proposal_samples=(24,), num_nerf_samples=24,
                               proposal_warmup=50),
        encoder=EncoderResnetCfg(norm_type="group", num_layers=3))


def main(argv=None) -> dict:
    tmp = Path(tempfile.gettempdir())
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(tmp / "njf_vis"))
    ap.add_argument("--scene", default=str(tmp / "njf_3d_scene"))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--hw", type=int, nargs=2, default=(48, 64))
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, "the example")

    h, w = args.hw
    scene = Path(args.scene)
    if not (scene / "transforms.json").exists():
        make_synthetic_scene(scene, num_cameras=3, num_trajs=2, frames_per_traj=4, height=h,
                             width=w, action_dim=3)

    model = Model(model_cfg())
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(dev)
    ds = get_dataset(DatasetCfgCommon(name="allegro", mode="perception", root=scene,
                                      num_total_joints=3), "train")
    loader = iter(DataLoader(ds, batch_size=4, num_workers=0))
    tcfg = TrainCfg(mode="perception", rays_per_batch=128, lr=5e-4, warm_up_steps=20)
    batch0 = to_device(next(loader), dev)
    state = create_train_state(model, tcfg)
    step = make_train_step(model, tcfg)
    generator = torch.Generator(device=dev).manual_seed(100)
    print(f"training tiny perception model for {args.steps} steps...")
    losses = []
    for i in range(args.steps):
        m = step(state, to_device(next(loader), dev), generator=generator)
        losses.append(float(m["loss/rgb"]))
        if (i + 1) % 25 == 0:
            print(f"  step {i + 1}: rgb={losses[-1]:.4f}")

    mi, _ = prepare_training_batch(batch0, 8, torch.Generator(device=dev).manual_seed(5))
    out = render_camera(model, mi.camera_input, mi.robot_input, z_near=0.5, z_far=10.0,
                        height=h, width=w, patch_size=512)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    rgb = out.rgb[0].float().cpu().numpy()
    write_rgb(outdir / "rgb.png", (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
    write_rgb(outdir / "depth.png", depth_colormap(out.depth_raw[0].float().cpu().numpy()))
    write_rgb(outdir / "flow.png", flow_to_rgb(out.flow_raw[0].float().cpu().numpy()))
    sens = compute_joint_sensitivity(out.action_features.float().cpu().numpy())
    palette = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32).T
    img = visualize_joint_sensitivity(sens, palette)
    write_rgb(outdir / "sensitivity.png", img[0])
    print("wrote rgb/depth/flow/sensitivity pngs ->", outdir)
    return dict(losses=losses, render=out, sensitivity=sens, out=outdir)


if __name__ == "__main__":
    main()
