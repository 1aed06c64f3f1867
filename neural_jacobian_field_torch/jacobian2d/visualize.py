"""2D pipeline visualisation (PyTorch counterpart of jacobian2d/visualize.py):
batched whole-trajectory inference and the sensitivity and flow videos the
tutorials write (model_wrapper_pusher.py:99-297)."""

from typing import Dict, List, Optional

import numpy as np
import torch

from ..inference.render import flow_to_rgb
from .models import compute_sensitivity, predict_2d


@torch.no_grad()
def visualize_model(model, video: np.ndarray, commands: np.ndarray,
                    batch_size: int = 12) -> Dict[str, np.ndarray]:
    """Chunked whole-trajectory inference on the model's device (a captured
    program per chunk shape on the card: `models.predict_2d`). video [T,
    H, W, 3]; commands [T - 1, C] -> {"flow" [T - 1, H, W, 2], "jacobian"
    [T - 1, H, W, C * S]} on the host."""
    dev = next(model.parameters()).device
    frames = torch.as_tensor(np.asarray(video[:-1]), dtype=torch.float32)
    cmds = torch.as_tensor(np.asarray(commands), dtype=torch.float32)
    flows, jacs = [], []
    for i in range(0, len(frames), batch_size):
        out = predict_2d(model, frames[i:i + batch_size].to(dev), cmds[i:i + batch_size].to(dev))
        flows.append(out.flow.cpu().numpy())
        jacs.append(out.jacobian.cpu().numpy())
    return {"flow": np.concatenate(flows), "jacobian": np.concatenate(jacs)}


def visualize_sensitivity(jacobian: np.ndarray, palette: Optional[np.ndarray] = None,
                          spatial_dim: int = 2) -> np.ndarray:
    """Per-command sensitivity mixed into uint8 frames by a palette [3, C]
    (a distinct hue per command by default). jacobian [T, H, W, C * S]."""
    sens = compute_sensitivity(torch.as_tensor(np.asarray(jacobian)), spatial_dim).numpy()
    c = sens.shape[-1]
    if palette is None:
        palette = np.stack([
            np.array([1.0, 0.2, 0.2]), np.array([0.2, 1.0, 0.2]),
            np.array([0.2, 0.4, 1.0]), np.array([1.0, 0.8, 0.1]),
            np.array([0.9, 0.2, 0.9]), np.array([0.2, 0.9, 0.9]),
        ][:c]).T  # [3, C]
    mixed = np.einsum("thwc,rc->thwr", sens, palette[:, :c])
    mixed = mixed / (mixed.max(axis=(1, 2, 3), keepdims=True) + 1e-10)
    return ((1.0 - np.clip(mixed, 0, 1)) * 255).astype(np.uint8)


def flow_video(flow: np.ndarray) -> np.ndarray:
    """[T, H, W, 2] -> uint8 [T, H, W, 3] on one colour scale."""
    max_norm = max(float(np.linalg.norm(flow, axis=-1).max()), 1e-8)
    return np.stack([flow_to_rgb(f, max_norm=max_norm) for f in flow])


def create_video_grid(videos: List[np.ndarray], pad: int = 2) -> np.ndarray:
    """Equally sized uint8 videos [T, H, W, 3] side by side, white spacers."""
    t, h, _, c = videos[0].shape
    spacer = np.full((t, h, pad, c), 255, np.uint8)
    tiles = []
    for i, v in enumerate(videos):
        tiles.append(v)
        if i < len(videos) - 1:
            tiles.append(spacer)
    return np.concatenate(tiles, axis=2)
