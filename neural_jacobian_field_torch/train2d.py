"""The 2D pipeline's training CLI (PyTorch counterpart of the JAX package's
train2d.py, the reference's `python -m jacobian.train`):

  python -m neural_jacobian_field_torch.train2d [--device cpu] \\
      dataset=pusher_only wrapper=pusher_only \\
      dataset.root=/path/to/trajectories training.max_steps=2000

YAML groups and dotted overrides over the repository's configurations2d/.
The legacy flag form of the tutorials (`--root ... --model unet ...`) is
taken where any argument besides --device starts with "--". It runs on the
card unless --device names another device.

Data: gzip-pickled trajectories under <root>/train/; make_synthetic=true (or
an empty root) writes a synthetic set of 16 trajectories of 8 frames at
64x64 first. The step is a captured program on the card
(jacobian2d/train.make_train_step_2d). Checkpoint: the flat Flax param tree
(utils/from_jax.params_2d_flat: "/"-joined names, Flax layouts) as an .npz,
the file JAX's train2d writes, so a port-trained model loads into the JAX
tutorials and a JAX-trained one into the port (`load_params_2d`).
"""

import random
import sys
import time
from dataclasses import replace
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .jacobian2d.config import CONFIG2D_DIR
from .utils.device import resolve_device


def load_params_2d(model: torch.nn.Module, path) -> torch.nn.Module:
    """Load a 2D params .npz (JAX's or the port's train2d) into `model`
    (strict)."""
    from .utils.from_jax import from_jax_params_2d

    with np.load(path) as f:
        state = from_jax_params_2d({k: f[k] for k in f.files})
    model.load_state_dict(state, strict=True)
    return model


def train2d(cfg, log=print, device=None):
    """Train from a typed Pipeline2DCfg; returns (state, params path)."""
    from .jacobian2d import (Dataset2D, Dataset2DCfg, Train2DCfg, collate_2d,
                             create_train_state_2d, get_model, make_synthetic_trajectories,
                             make_train_step_2d)
    from .utils.from_jax import params_2d_flat

    dev = resolve_device(device, "2D training")
    root = Path(cfg.dataset.root)
    if cfg.make_synthetic or not (root / "train").exists():
        log(f"generating synthetic trajectories -> {root}")
        make_synthetic_trajectories(root, num_trajs=16, num_steps=8, height=64, width=64,
                                    command_dim=cfg.dataset.command_dim)
    resize = None
    if cfg.dataset.new_H is not None and cfg.dataset.new_W is not None:
        resize = (cfg.dataset.new_H, cfg.dataset.new_W)
    ds = Dataset2D(Dataset2DCfg(name=cfg.dataset.name, root=root,
                                command_dim=cfg.dataset.command_dim,
                                action_scale=cfg.dataset.action_scale, resize_hw=resize),
                   "train", rng=random.Random(cfg.seed))
    log(f"dataset: {ds.num_files} trajectories ({cfg.dataset.name})")

    model_cfg = cfg.wrapper.model
    if model_cfg.command_dim != cfg.dataset.command_dim:
        model_cfg = replace(model_cfg, command_dim=cfg.dataset.command_dim)
    model = get_model(model_cfg).init_weights(torch.Generator().manual_seed(cfg.seed)).to(dev)
    if cfg.checkpoint.load:
        load_params_2d(model, cfg.checkpoint.load)
    tcfg = Train2DCfg(lr=cfg.wrapper.optim.lr, weight_decay=cfg.wrapper.optim.weight_decay,
                      warm_up_steps=cfg.wrapper.optim.warm_up_steps)
    rng = np.random.default_rng(cfg.seed)
    batch_size = cfg.training.data.batch_size

    def batch():
        idx = rng.integers(0, len(ds), batch_size)
        return collate_2d([ds[int(i)] for i in idx])

    batch()  # JAX's init draws one batch first; the training batches follow it
    state = create_train_state_2d(model, tcfg)
    step = make_train_step_2d(model, tcfg)
    steps = cfg.training.max_steps
    t0 = first = time.time()
    for i in range(steps):
        m = step(state, batch())
        if i == 0:
            first = time.time()
        if (i + 1) % 100 == 0 or i + 1 == steps:
            now = time.time()
            after = f"; {i / (now - first):.1f} after the first" if i and now > first else ""
            log(f"step {i + 1}: loss={float(m['train/loss']):.6f} "
                f"({(i + 1) / (now - t0):.1f} steps/s{after})")
    out = Path(cfg.checkpoint.out) if cfg.checkpoint.out else root / "params.npz"
    np.savez(out, **params_2d_flat(model))
    log(f"saved params -> {out}")
    return state, out


def _legacy_argparse(argv):
    """The tutorials' flag form, mapped onto the typed config's overrides."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="/tmp/njf_2d_data")
    ap.add_argument("--dataset", default="pusher", choices=["pusher", "planar_hand"])
    ap.add_argument("--model", default="unet", choices=["unet", "transformer"])
    ap.add_argument("--command-dim", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--warmup", type=int, default=1000)
    ap.add_argument("--resize", type=int, nargs=2, default=None)
    ap.add_argument("--make-synthetic", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    overrides = [
        f"dataset.name={args.dataset}", f"dataset.root={args.root}",
        f"dataset.command_dim={args.command_dim}",
        f"wrapper.model.name={args.model}",
        f"wrapper.model.command_dim={args.command_dim}",
        f"wrapper.optim.lr={args.lr}", f"wrapper.optim.warm_up_steps={args.warmup}",
        f"training.max_steps={args.steps}",
        f"training.data.batch_size={args.batch_size}",
        f"seed={args.seed}",
        f"make_synthetic={str(args.make_synthetic).lower()}",
    ]
    if args.resize:
        overrides += [f"dataset.new_H={args.resize[0]}", f"dataset.new_W={args.resize[1]}"]
    if args.out:
        overrides.append(f"checkpoint.out={args.out}")
    return overrides


def split_device(argv) -> tuple:
    """(device or None, the other arguments): --device X / --device=X."""
    rest, device, it = [], None, iter(argv)
    for a in it:
        if a == "--device":
            device = next(it)
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    return device, rest


def main(argv: Optional[list] = None, log=print):
    """Parse, load the config and train; returns (state, params path)."""
    from .config import load_config
    from .jacobian2d.config import get_typed_2d_config

    device, argv = split_device(list(argv if argv is not None else sys.argv[1:]))
    if any(a.startswith("--") for a in argv):
        argv = _legacy_argparse(argv)
    cfg = get_typed_2d_config(load_config(CONFIG2D_DIR, argv))
    return train2d(cfg, log=log, device=device)


if __name__ == "__main__":
    main()
