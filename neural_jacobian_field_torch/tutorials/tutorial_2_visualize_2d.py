"""Tutorial 2: visualise the trained 2D Jacobian field: whole-trajectory
inference, then flow and per-command sensitivity videos as png frame strips
(rgb | true flow | predicted flow | sensitivity).

Run after tutorial 1:
  python -m neural_jacobian_field_torch.tutorials.tutorial_2_visualize_2d [--device cpu]
"""

import argparse
import random
from pathlib import Path

import numpy as np
import torch

from ..jacobian2d import (Dataset2D, Dataset2DCfg, UnetJacobianField, UnetJacobianFieldCfg,
                          create_video_grid, flow_video, visualize_model, visualize_sensitivity)
from ..train2d import load_params_2d
from ..utils.device import resolve_device


def main(argv=None):
    from PIL import Image

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="/tmp/njf_2d_data")
    ap.add_argument("--out", default="/tmp/njf_2d_vis")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, "tutorial 2")

    root = Path(args.root)
    model = UnetJacobianField(UnetJacobianFieldCfg())
    params_file = root / "params.npz"
    if params_file.exists():
        load_params_2d(model, params_file)
    else:
        print("run tutorial 1 first; using random params")
        model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(dev)

    ds = Dataset2D(Dataset2DCfg(name="pusher", root=root), "train", rng=random.Random(0))
    val = ds.get_val_item(0)
    preds = visualize_model(model, val["input_video_sequence"], val["input_command_sequence"])
    grid = create_video_grid([
        (val["input_video_sequence"][:-1] * 255).astype(np.uint8),
        flow_video(val["trgt_flow_sequence"][:-1]), flow_video(preds["flow"]),
        visualize_sensitivity(preds["jacobian"])])
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for t in range(len(grid)):
        Image.fromarray(grid[t]).save(out / f"frame_{t:03d}.png")
    print(f"wrote {len(grid)} grid frames (rgb | gt flow | pred flow | sensitivity) -> {out}")
    return grid


if __name__ == "__main__":
    main()
