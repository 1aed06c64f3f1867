"""Tutorial 1: generate 2D pusher data and train the UNet Jacobian field.

The reference generates pusher trajectories with MuJoCo and RAFT flow; the
data here is the synthetic pusher (analytic flow) unless --root holds
trajectories. Writes <root>/params.npz (JAX's layout).

  python -m neural_jacobian_field_torch.tutorials.tutorial_1_train_2d_pusher \\
      [--steps 500] [--device cpu]
"""

import argparse
import random
from pathlib import Path

import numpy as np
import torch

from ..jacobian2d import (Dataset2D, Dataset2DCfg, Train2DCfg, UnetJacobianField,
                          UnetJacobianFieldCfg, collate_2d, create_train_state_2d,
                          make_synthetic_trajectories, make_train_step_2d)
from ..utils.device import resolve_device
from ..utils.from_jax import params_2d_flat


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="/tmp/njf_2d_data")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, "tutorial 1")

    root = Path(args.root)
    if not (root / "train").exists():
        print("generating synthetic trajectories ->", root)
        make_synthetic_trajectories(root, num_trajs=16, num_steps=8, height=64, width=64)
    ds = Dataset2D(Dataset2DCfg(name="pusher", root=root), "train", rng=random.Random(0))
    model = UnetJacobianField(UnetJacobianFieldCfg()).init_weights(
        torch.Generator().manual_seed(0)).to(dev)
    cfg = Train2DCfg(lr=1e-3, warm_up_steps=50)
    rng = np.random.default_rng(0)

    def batch():
        return collate_2d([ds[int(i)] for i in rng.integers(0, len(ds), args.batch_size)])

    batch()  # the batch JAX's init draws
    state = create_train_state_2d(model, cfg)
    step = make_train_step_2d(model, cfg)
    losses = []
    for i in range(args.steps):
        m = step(state, batch())
        if (i + 1) % 50 == 0:
            losses.append(float(m["train/loss"]))
            print(f"step {i + 1}: loss={losses[-1]:.6f}")
    out = root / "params.npz"
    np.savez(out, **params_2d_flat(model))
    print("saved params ->", out)
    return out, losses


if __name__ == "__main__":
    main()
