"""Camera-path interpolation for validation videos (host-side NumPy; the
port's copy of visualization/view_interpolation.py): SO(3) axis-angle pose
slerp, intrinsics lerp, the wobble path and the depth-based reprojection
helper."""

from typing import Optional

import numpy as np


def _log_so3(r: np.ndarray) -> np.ndarray:
    """Rotation matrix -> rotation vector (axis * angle)."""
    cos_theta = np.clip((np.trace(r) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos_theta)
    if theta < 1e-8:
        return np.zeros(3)
    if np.pi - theta < 1e-6:
        # near-pi: extract axis from r + I
        m = (r + np.eye(3)) / 2.0
        axis = np.sqrt(np.maximum(np.diagonal(m), 0.0))
        axis = axis / (np.linalg.norm(axis) + 1e-12)
        # fix signs using off-diagonals
        if m[0, 1] < 0:
            axis[1] = -axis[1]
        if m[0, 2] < 0:
            axis[2] = -axis[2]
        return axis * theta
    vec = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    return vec / (2.0 * np.sin(theta)) * theta


def _exp_so3(v: np.ndarray) -> np.ndarray:
    """Rotation vector -> rotation matrix (Rodrigues)."""
    theta = np.linalg.norm(v)
    if theta < 1e-8:
        return np.eye(3)
    k = v / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * kx @ kx


def interpolate_pose(initial: np.ndarray, final: np.ndarray, t: float) -> np.ndarray:
    """Axis-angle slerp of the relative rotation + lerp of translation
    (view_interpolation.py:9-36)."""
    r_initial = initial[:3, :3]
    r_final = final[:3, :3]
    r_relative = _exp_so3(_log_so3(r_final @ r_initial.T) * t)
    result = np.zeros_like(initial)
    result[3, 3] = 1.0
    result[:3, :3] = r_relative @ r_initial
    result[:3, 3] = initial[:3, 3] + (final[:3, 3] - initial[:3, 3]) * t
    return result


def interpolate_intrinsics(initial: np.ndarray, final: np.ndarray, t: float) -> np.ndarray:
    """view_interpolation.py:39-45."""
    return initial + (final - initial) * t


def generate_wobble(tf: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Spiral wobble path around a base pose (view_interpolation.py:48-57).
    tf: [B, 4, 4]; t: [V]. Returns [B, V, 4, 4]."""
    v = len(t)
    tf_translation = np.broadcast_to(np.eye(4, dtype=np.float32), (1, v, 4, 4)).copy()
    tf_translation[0, :, 0, 3] = np.sin(2 * np.pi * t) * (0.5 * t)
    tf_translation[0, :, 1, 3] = -np.cos(2 * np.pi * t) * (0.5 * t)
    return tf[:, None] @ tf_translation


def reproj_best(
    src_steps: np.ndarray,
    src_weights: np.ndarray,
    src_c2w: np.ndarray,
    tgt_c2w: np.ndarray,
    src_intrinsics: np.ndarray,
    tgt_intrinsics: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Reproject each pixel's argmax-weight depth into a target view
    (view_interpolation.py:60-96). steps/weights: [H, W, N]; intrinsics in
    pixel units. Returns integer pixel map [H, W, 2]."""
    if tgt_intrinsics is None:
        tgt_intrinsics = src_intrinsics
    h, w = src_steps.shape[:2]
    best = np.argmax(src_weights, axis=-1)
    z = np.take_along_axis(src_steps, best[..., None], axis=-1)  # [H, W, 1]

    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    xy = np.stack([xs, ys], axis=-1).astype(np.float64)
    ones = np.ones((h, w, 1))
    xyz_cam = np.concatenate([xy, ones], axis=-1) * z
    xyz_cam = xyz_cam @ np.linalg.inv(src_intrinsics).T
    xyz_world = np.concatenate([xyz_cam, ones], axis=-1) @ src_c2w.T
    xy_b = (xyz_world @ np.linalg.inv(tgt_c2w).T)[..., :3] @ tgt_intrinsics.T
    xy_b = xy_b[..., :2] / xy_b[..., 2:]
    xy_b = np.round(xy_b).astype(np.int64)
    xy_b[..., 0] = np.clip(xy_b[..., 0], 0, w - 1)
    xy_b[..., 1] = np.clip(xy_b[..., 1], 0, h - 1)
    return xy_b


def cosine_smooth(t: float) -> float:
    """Ping-pong easing used for video paths (model_wrapper.py:233)."""
    return (np.cos(np.pi * (t + 1)) + 1) / 2
