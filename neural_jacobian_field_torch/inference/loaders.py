"""Notebook and inference loaders (PyTorch counterpart of
inference/loaders.py): parse a nerfstudio-style camera json into a camera
context, build a model from the configurations tree and restore a
checkpoint this port wrote (training/checkpoint.py), and resolve a
checkpoint URI. The port's module is its own parameter tree, so no template
initialisation is needed before the restore.
"""

import json
from typing import Dict, Optional

import numpy as np
import torch

from ..config import get_typed_root_config, load_config
from ..data.conventions import normalize_intrinsics, post_process_camera_to_world
from ..models.model import Model
from ..training.checkpoint import load_batch_stats, load_params_only
from ..utils.device import resolve_device


def parse_camera_json(path, downscale: float = 1.0) -> Dict[str, np.ndarray]:
    """nerfstudio camera json -> {c2w [4,4] OpenCV, intrinsics [3,3]
    normalized, height, width} (inference/loaders.py:51-112). Takes a
    single camera ("transform_matrix" or "camera_to_world"; "fl_x"/"fl_y"
    or "fov"), or the viewer's export ("camera_path", its first camera)."""
    with open(path, encoding="utf-8") as f:
        cam = json.load(f)
    if "camera_path" in cam:  # nerfstudio viewer export
        cam = cam["camera_path"][0]
    c2w = np.asarray(cam["camera_to_world"] if "camera_to_world" in cam
                     else cam["transform_matrix"], dtype=np.float32).reshape(4, 4)
    h = int(cam.get("h", cam.get("height")))
    w = int(cam.get("w", cam.get("width")))
    if "fl_x" in cam:
        fx, fy = float(cam["fl_x"]), float(cam["fl_y"])
        cx, cy = float(cam.get("cx", w / 2)), float(cam.get("cy", h / 2))
    else:  # fov-style export
        fov = float(cam["fov"])
        fx = fy = 0.5 * h / np.tan(0.5 * np.deg2rad(fov))
        cx, cy = w / 2, h / 2
    intr = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32) / downscale
    intr[2, 2] = 1.0
    h, w = int(h / downscale), int(w / downscale)
    return {
        "c2w": post_process_camera_to_world(c2w),
        "intrinsics": normalize_intrinsics(intr, h, w),
        "height": h,
        "width": w,
    }


def load_model(config_dir, checkpoint_path=None, overrides=(),
               compute_dtype: Optional[torch.dtype] = None, device=None) -> Model:
    """Build the model from the configurations tree under `config_dir` with
    CLI-style dotted `overrides`, initialise it from the config's seed, and
    restore the parameters and the BatchNorm running statistics of the
    latest checkpoint in `checkpoint_path` (a directory of
    training/checkpoint.py's files; shape-tolerant: entries the checkpoint
    lacks keep the seeded ones). Returns the model in eval mode on the card,
    or on `device` where the caller names one; raises where there is no
    card and no device is named."""
    dev = resolve_device(device, "the model")
    cfg = get_typed_root_config(load_config(config_dir, list(overrides)))
    model = Model(cfg=cfg.model, compute_dtype=compute_dtype)
    model.init_weights(torch.Generator().manual_seed(cfg.seed))
    if checkpoint_path is not None:
        load_params_only(checkpoint_path, model)
        # eval-mode BatchNorm reads the running statistics; fresh ones
        # degrade the render badly
        load_batch_stats(checkpoint_path, model)
    return model.to(dev).eval()


def resolve_checkpoint(uri: str, download_dir="checkpoints") -> str:
    """Resolve a checkpoint URI (utils/wandb_ckpt.py:49-71): local paths pass
    through; wandb://entity/project/run:vN downloads the artifact when wandb
    is importable and logged in."""
    if not str(uri).startswith("wandb://"):
        return str(uri)
    try:
        import wandb
    except ImportError as e:
        raise RuntimeError(
            "wandb:// checkpoint URIs need the wandb package; in zero-egress "
            "environments pass a local checkpoint directory instead"
        ) from e
    spec = str(uri)[len("wandb://"):]
    run_path, _, version = spec.partition(":")
    version = version or "latest"
    api = wandb.Api()
    artifact = api.artifact(f"{run_path}:{version}")
    return artifact.download(root=download_dir)
