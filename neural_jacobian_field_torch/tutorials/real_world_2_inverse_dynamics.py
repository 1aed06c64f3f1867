"""Real world 2: inverse dynamics, the action recovered from a desired
motion (the port's counterpart of examples/real_world_2_inverse_dynamics.py,
the reference's notebooks/real_world/2_inverse_dynamics.ipynb cell 17):
encode the scene once (`Model.encode_image` caches density and Jacobian),
then 100 Adam iterations on the action so that the predicted optical flow
matches a target (one captured program on the card), and the one-shot
least-squares solve.

  python -m neural_jacobian_field_torch.tutorials.real_world_2_inverse_dynamics \\
      [--scene DIR] [--iters 100] [--device cpu]
"""

import argparse
import dataclasses
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..data import DataLoader, DatasetCfgCommon, get_dataset, make_synthetic_scene
from ..inference.action_opt import optimize_actions, solve_actions_least_squares
from ..models.encoder_resnet import EncoderResnetCfg
from ..models.model import Model, RenderingCfg, RobotInput, make_model_cfg
from ..parallel import to_device
from ..training import prepare_training_batch
from ..utils.device import resolve_device

TRUE_ACTION = (0.4, -0.2, 0.6)


def model_cfg():
    """The example's model: jacobian_mlp over 3 joints, a 3-stage group-norm
    encoder, 16 + 16 samples."""
    return make_model_cfg(
        "jacobian_mlp", action_dim=3,
        rendering=RenderingCfg(num_proposal_samples=(16,), num_nerf_samples=16),
        encoder=EncoderResnetCfg(norm_type="group", num_layers=3))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default=str(Path(tempfile.gettempdir()) / "njf_3d_scene_inv"))
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, "the example")

    scene = Path(args.scene)
    if not (scene / "transforms.json").exists():
        make_synthetic_scene(scene, num_cameras=3, num_trajs=2, frames_per_traj=4, height=48,
                             width=64, action_dim=3)
    model = Model(model_cfg())
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(dev)
    ds = get_dataset(DatasetCfgCommon(name="allegro", mode="perception", root=scene,
                                      num_total_joints=3), "train")
    batch = to_device(next(iter(DataLoader(ds, batch_size=1, num_workers=0))), dev)
    g = torch.Generator(device=dev).manual_seed(1)
    mi, _ = prepare_training_batch(batch, 256, g)

    # encode once (no gradient through the field afterwards)
    enc = model.encode_image(mi.camera_input, mi.rendering_input, mi.robot_input)
    # stand in for a trained Jacobian: any fixed non-zero field shows the math
    enc = dataclasses.replace(enc, action_features=torch.randn(
        enc.action_features.shape, generator=g, device=dev) * 0.05)

    true_action = torch.tensor([TRUE_ACTION], device=dev)
    target_flow = model.infer_optical_flow(enc, mi.camera_input, RobotInput(true_action))
    result = optimize_actions(model, enc, mi.camera_input, target_flow, generator=g,
                              num_iters=args.iters, learning_rate=0.1)
    print(f"Adam ({args.iters} iters, one program):")
    print("  true action:", np.asarray(TRUE_ACTION).round(3))
    print("  recovered:  ", result.action[0].cpu().numpy().round(3),
          f"(loss {float(result.loss):.2e})")
    a_ls = solve_actions_least_squares(model, enc, mi.camera_input, target_flow)
    print("closed-form least squares:")
    print("  recovered:  ", a_ls[0].cpu().numpy().round(3))
    return dict(true_action=true_action.cpu(), adam=result.action.cpu(),
                losses=result.losses.cpu(), least_squares=a_ls.cpu())


if __name__ == "__main__":
    main()
