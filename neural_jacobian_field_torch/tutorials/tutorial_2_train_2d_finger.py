"""Tutorial 2: train the planar-hand ("finger") Jacobian field in 2D.

The reference trains a DINOv2-backed transformer Jacobian on MuJoCo
planar-hand trajectories; here the data is the synthetic planar hand (two
fingertip squares, each driven by 2 of the 4 joints: a block-structured
Jacobian) and the model the same frozen-ViT + UNet-decoder architecture
(load real DINOv2 weights with jacobian2d.load_torch_dinov2_state_dict).
The ViT depth is 2 for a quick demo; --full-vit for ViT-S/14's 12.

  python -m neural_jacobian_field_torch.tutorials.tutorial_2_train_2d_finger \\
      [--steps 300] [--full-vit] [--device cpu]
"""

import argparse
import random
from pathlib import Path

import numpy as np
import torch

from ..jacobian2d import (Dataset2D, Dataset2DCfg, Train2DCfg, TransformerJacobianField,
                          TransformerJacobianFieldCfg, ViTCfg, collate_2d,
                          create_train_state_2d, make_synthetic_trajectories, make_train_step_2d)
from ..utils.device import resolve_device
from ..utils.from_jax import params_2d_flat


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="/tmp/njf_2d_finger")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--full-vit", action="store_true",
                    help="the DINOv2 ViT-S/14 depth (12); the demo's is 2")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, "tutorial 2")

    root = Path(args.root)
    if not (root / "train").exists():
        print("generating synthetic planar-hand trajectories ->", root)
        # 56x56: a multiple of the ViT's patch size (14)
        make_synthetic_trajectories(root, num_trajs=16, num_steps=8, height=56, width=56,
                                    scene="planar_hand")
    ds = Dataset2D(Dataset2DCfg(name="planar_hand", root=root, command_dim=4), "train",
                   rng=random.Random(0))
    vit = ViTCfg() if args.full_vit else ViTCfg(depth=2)
    model = TransformerJacobianField(TransformerJacobianFieldCfg(command_dim=4, vit=vit))
    model = model.init_weights(torch.Generator().manual_seed(0)).to(dev)
    dino0 = {k: v.detach().clone() for k, v in model.dino.state_dict().items()}
    cfg = Train2DCfg(lr=1e-3, warm_up_steps=50)
    rng = np.random.default_rng(0)

    def batch():
        return collate_2d([ds[int(i)] for i in rng.integers(0, len(ds), args.batch_size)])

    batch()  # the batch JAX's init draws
    state = create_train_state_2d(model, cfg)
    step = make_train_step_2d(model, cfg)
    first = loss = None
    for i in range(args.steps):
        m = step(state, batch())
        if i == 0 or (i + 1) % 50 == 0 or i + 1 == args.steps:
            loss = float(m["train/loss"])
            first = loss if first is None else first
            if (i + 1) % 50 == 0:
                print(f"step {i + 1}: loss={loss:.6f}")
    # the DINO backbone stays bit for bit as it was (the reference never
    # hands it to the optimizer)
    frozen = all(torch.equal(v, model.dino.state_dict()[k]) for k, v in dino0.items())
    out = root / "params.npz"
    np.savez(out, **params_2d_flat(model))
    print(f"trained {args.steps} steps: loss {first:.5f} -> {loss:.6f}; dino frozen {frozen}; "
          f"params -> {out}")
    return out, first, loss, frozen


if __name__ == "__main__":
    main()
