"""Joint-sensitivity maps of the Jacobian field (the port's copy of the
JAX package's inference/sensitivity.py, which is pure NumPy): per-joint
sensitivity = ||J_i(x)|| (optionally after transforming J into the camera
frame), min-max normalised per joint, then colour-mixed with a per-robot
palette; the kinematic-chain overlay. It reads a render's
`action_features` [B, H, W, A*3], a torch tensor (moved to the host) or an
array.
"""

from typing import Dict, List, Optional

import numpy as np
import torch

# inference/jacobian_color_map.py:13-50
JACOBIAN_COLORMAP: Dict[str, List[List[float]]] = {
    "model_allegro": [
        [0.0, 0.5, 0.5], [0, 1, 0], [0.8, 0.1, 0.1], [0.8, 0.0, 0.8],
        [0.0, 0.8, 0], [1.0, 0.8, 0], [1, 1, 0], [1, 0.0, 0.0],
    ],
    "model_allegro_transformer": [
        [0.0, 0.5, 0.5], [0, 1, 0], [0.8, 0.1, 0.1], [0.8, 0.0, 0.8],
        [0.0, 0.8, 0], [1.0, 0.8, 0], [1, 1, 0], [1, 0.0, 0.0],
    ],
    "model_toy_arm": [
        [0.5, 0.8, 0.2], [0.9, 0.2, 0.0], [0, 0.8, 0], [1.0, 0.0, 1.0],
        [0, 0, 1], [0.1, 0.9, 0.7],
    ],
    "model_pneumatic_hand_only": [
        [0, 0, 1], [0.9, 0.2, 0.0], [0, 0.9, 0], [1.0, 0.0, 1.0],
        [0.1, 0.9, 0.7], [0.5, 0.8, 0.2],
    ],
}


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def compute_joint_sensitivity(
    jacobians: np.ndarray,
    extrinsics: Optional[np.ndarray] = None,
    mode: int = 0,
) -> np.ndarray:
    """[..., H, W, A*3] composited Jacobians -> [..., A, H, W] sensitivity
    in [0, 1] (jacobian_color_map.py:53-90). A torch tensor is copied to
    the host first (bf16 and f16 as float32)."""
    j = _host(jacobians)
    *lead, h, w, ad = j.shape
    j = j.reshape(*lead, h, w, ad // 3, 3)
    if extrinsics is not None:
        # homogeneous vector transform into the camera frame
        j_h = np.concatenate([j, np.zeros_like(j[..., :1])], axis=-1)
        ext = _host(extrinsics).reshape(*lead, 1, 1, 1, 4, 4)
        j = np.einsum("...ij,...j->...i", ext, j_h)[..., :3]
    sens = np.linalg.norm(j, axis=-1)  # [..., H, W, A]
    sens = np.moveaxis(sens, -1, -3)  # [..., A, H, W]
    minima = sens.min(axis=(-2, -1), keepdims=True)
    maxima = sens.max(axis=(-2, -1), keepdims=True)
    sens = (sens - minima) / (maxima - minima + 1e-10)
    if mode == 1:
        sens = 1.1 - sens
    return np.clip(sens, 0.0, 1.0)


def visualize_joint_sensitivity(sensitivity: np.ndarray,
                                color_map: np.ndarray) -> np.ndarray:
    """[..., A, H, W] sensitivity + [3, A] palette -> uint8 [..., H, W, 3]
    (jacobian_color_map.py:92-109; output is inverted as in the reference)."""
    mixed = np.einsum("...ahw,ca->...chw", sensitivity, np.asarray(color_map))
    minima = mixed.min(axis=(-2, -1), keepdims=True)
    maxima = mixed.max(axis=(-2, -1), keepdims=True)
    mixed = np.clip((mixed - minima) / (maxima - minima + 1e-10), 0, 1)
    mixed = np.moveaxis(mixed, -3, -1)
    return ((1.0 - mixed) * 255).astype(np.uint8)


def compute_joint_sensitivity_point_cloud(jacobians: np.ndarray) -> np.ndarray:
    """[N, A, 3] per-point Jacobians -> [N, A] norms
    (jacobian_color_map.py:112-135)."""
    return np.linalg.norm(_host(jacobians), axis=-1)


def _normalize_image(image: np.ndarray) -> np.ndarray:
    return (image - image.min()) / (image.max() - image.min() + 1e-12)


def _resize_hw(img: np.ndarray, height: int, width: int) -> np.ndarray:
    from PIL import Image

    return np.asarray(
        Image.fromarray(img.astype(np.float32), mode="F").resize(
            (width, height), Image.BILINEAR
        )
    )


def visualize_jacobian_chain_structure(
    input_image: np.ndarray,
    joint_sensitivity: np.ndarray,
    joint_colors: np.ndarray,
    links: range = range(1, 5),
):
    """Kinematic-chain overlay (jacobian_color_map.py:182-273).

    For consecutive joints along a serial chain, the region moved by joint i
    but NOT by joint i+1 is link i — the clipped sensitivity difference
    isolates it; each link mask is colorized with its joint color and
    alpha-composited over (a) the input image at 155/255 opacity and (b) a
    white canvas. `links` defaults to the reference's 5-link toy arm
    (hardcoded `range(1, 5)` there).

    Args:
      input_image: uint8 [H, W, 3].
      joint_sensitivity: [A, h, w] in [0, 1] (compute_joint_sensitivity).
      joint_colors: [A, 3] floats in [0, 1].

    Returns: (overlay_rgba, white_bkgd_rgba) uint8 [H, W, 4].
    """
    from PIL import Image

    height, width, _ = input_image.shape
    sens = np.asarray(joint_sensitivity, dtype=np.float32)
    joint_colors = np.asarray(joint_colors, dtype=np.float32)

    diff_masks = []
    projected_layers = []
    last = links[-1] if len(links) else 0
    for i in links:
        prev_s = np.clip(sens[i], 0.10, 1.5)
        next_s = np.clip(sens[i + 1], 0.10, 1.5)
        diff = _normalize_image(np.clip(prev_s - next_s, 0.01, 1.0))
        diff = _resize_hw(diff, height, width)
        projected = diff[..., None] * joint_colors[i]
        norm = _normalize_image(projected)
        diff_masks.append(diff)
        projected_layers.append((norm * 255).clip(0, 255).astype(np.uint8))

    # terminal link: the last joint's own sensitivity (ref :236-247)
    next_s = _resize_hw(np.clip(sens[last + 1], 0.10, 1.5), height, width)
    diff_masks.append(next_s.copy())
    next_s = _normalize_image(np.clip(next_s, 0.25, 1.0))
    projected = next_s[..., None] * joint_colors[last + 1]
    projected_layers.append(
        (_normalize_image(projected) * 255).clip(0, 255).astype(np.uint8)
    )

    overlay = np.concatenate(
        [input_image, np.full((height, width, 1), 155, np.uint8)], axis=-1
    )
    white = np.concatenate(
        [np.full((height, width, 3), 255, np.uint8),
         np.full((height, width, 1), 255, np.uint8)], axis=-1
    )
    canvas_overlay = Image.fromarray(overlay, mode="RGBA")
    canvas_white = Image.fromarray(white, mode="RGBA")

    for layer, diff in zip(projected_layers, diff_masks):
        alpha = (np.clip(_normalize_image(diff) * 1.5, 0, 1) * 255).astype(np.uint8)
        rgba = np.concatenate([layer, alpha[..., None]], axis=-1)
        patch = Image.fromarray(rgba, mode="RGBA")
        canvas_overlay.paste(patch, (0, 0), patch)
        canvas_white.paste(patch, (0, 0), patch)

    return np.asarray(canvas_overlay), np.asarray(canvas_white)
