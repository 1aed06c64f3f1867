"""Synthetic nerfstudio-format scenes, an analytic sphere robot (the port's
copy of data/synthetic.py): a Lambertian sphere whose centre the "joint
positions" displace linearly (so the true Jacobian field is known in closed
form), seen from cameras on a circle, written in the on-disk layout the
datasets read: transforms.json with decoupled cameras[]/frames[],
rgb/view_{k}/TTTTT_FFFFF.png, depth as 16-bit millimetre PNGs, flow .npz
with fwd/bwd displacement, and TAPIR-style track files. The PNGs are
written through data/image_io.py."""

import json
from pathlib import Path

import numpy as np

from . import image_io

# sphere center displacement per unit qpos (the ground-truth Jacobian)
QPOS_GAIN = 0.25
SPHERE_RADIUS = 0.45


def _look_at_opengl(position: np.ndarray, target: np.ndarray) -> np.ndarray:
    """OpenGL cam2world (camera looks along -z) for transforms.json."""
    forward = target - position
    forward = forward / np.linalg.norm(forward)
    z = -forward
    up = np.array([0.0, 0.0, 1.0])
    x = np.cross(up, z)
    if np.linalg.norm(x) < 1e-6:
        x = np.array([1.0, 0.0, 0.0])
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, position
    return c2w


def sphere_center(qpos: np.ndarray) -> np.ndarray:
    c = np.zeros(3)
    c[: min(3, len(qpos))] = qpos[:3] * QPOS_GAIN
    return c


def _render_sphere(c2w_gl: np.ndarray, fx, fy, cx, cy, h, w, center):
    """Analytic ray-sphere render. Returns (rgb [H,W,3] f32, z-depth [H,W] f32
    with 0 = miss, hit_points [H,W,3], mask)."""
    ys, xs = np.mgrid[0:h, 0:w]
    # OpenCV-style pixel rays in camera frame (x right, y down, z forward)
    dirs_cv = np.stack(
        [(xs + 0.5 - cx) / fx, (ys + 0.5 - cy) / fy, np.ones_like(xs, np.float64)], -1
    )
    # OpenCV cam frame -> OpenGL cam frame (flip y, z)
    dirs_gl = dirs_cv * np.array([1.0, -1.0, -1.0])
    R, t = c2w_gl[:3, :3], c2w_gl[:3, 3]
    dirs_w = dirs_gl @ R.T
    norm = np.linalg.norm(dirs_w, axis=-1, keepdims=True)
    d = dirs_w / norm
    o = t[None, None, :]

    oc = o - center[None, None, :]
    b = np.sum(d * oc, -1)
    c_ = np.sum(oc * oc, -1) - SPHERE_RADIUS**2
    disc = b * b - c_
    hit = disc > 0
    t_hit = -b - np.sqrt(np.maximum(disc, 0.0))
    hit &= t_hit > 0

    points = o + d * t_hit[..., None]
    normals = (points - center) / SPHERE_RADIUS
    light = np.array([0.5, -0.3, 0.8])
    light = light / np.linalg.norm(light)
    lamb = np.clip(normals @ light, 0.0, 1.0)
    albedo = 0.5 + 0.5 * normals  # color encodes the normal (texture-ish)
    rgb = np.where(hit[..., None], albedo * (0.25 + 0.75 * lamb[..., None]), 1.0)

    # z-depth in the OpenCV camera frame = distance along camera forward
    forward_w = -R[:, 2]
    zdepth = np.where(hit, np.sum((points - t) * forward_w, -1), 0.0)
    return rgb.astype(np.float32), zdepth.astype(np.float32), points, hit


def _project(points_w, c2w_gl, fx, fy, cx, cy):
    """World -> OpenCV pixel coords (for analytic flow)."""
    R, t = c2w_gl[:3, :3], c2w_gl[:3, 3]
    pts_cam_gl = (points_w - t) @ R
    pts_cv = pts_cam_gl * np.array([1.0, -1.0, -1.0])
    x = pts_cv[..., 0] / pts_cv[..., 2] * fx + cx
    y = pts_cv[..., 1] / pts_cv[..., 2] * fy + cy
    return np.stack([x, y], -1)


def make_synthetic_scene(
    root,
    num_cameras: int = 3,
    num_trajs: int = 2,
    frames_per_traj: int = 4,
    height: int = 48,
    width: int = 64,
    action_dim: int = 3,
    seed: int = 0,
) -> Path:
    """Write a full synthetic dataset under `root`; returns root."""
    root = Path(root)
    rng = np.random.default_rng(seed)

    fx = fy = 0.9 * width
    cx, cy = width / 2.0, height / 2.0

    cam2worlds = []
    for k in range(num_cameras):
        ang = 2 * np.pi * k / num_cameras
        pos = np.array([2.2 * np.cos(ang), 2.2 * np.sin(ang), 1.2])
        cam2worlds.append(_look_at_opengl(pos, np.zeros(3)))

    cameras_json = [
        {"transform_matrix": c2w.tolist(), "fl_x": fx, "fl_y": fy, "cx": cx,
         "cy": cy, "h": height, "w": width}
        for c2w in cam2worlds
    ]

    # random-walk joint positions per trajectory
    qpos_all = {}
    for traj in range(num_trajs):
        q = rng.uniform(-1, 1, size=action_dim)
        for f in range(frames_per_traj):
            qpos_all[(traj, f)] = q.copy()
            q = np.clip(q + rng.normal(0, 0.35, size=action_dim), -1, 1)

    frames = []
    total = num_trajs * frames_per_traj
    rng_tracks = np.random.default_rng(seed + 1)
    for cam_idx, c2w in enumerate(cam2worlds):
        for traj in range(num_trajs):
            # TAPIR-style track files: on-sphere pixels of frame 0 tracked
            # analytically across the trajectory + background negatives
            # (io_utils.load_tapir_tracks format: point_track_data [N, T, 2]
            # xy, pixel_visible_mask [N, T], negative_yx [M, 2])
            track_points = None
            for f in range(frames_per_traj):
                q = qpos_all[(traj, f)]
                center = sphere_center(q)
                rgb, zdepth, points, hit = _render_sphere(
                    c2w, fx, fy, cx, cy, height, width, center
                )
                rel = f"rgb/view_{cam_idx}/{traj:05d}_{f:05d}.png"
                depth_rel = f"depth/view_{cam_idx}/{traj:05d}_{f:05d}.png"
                for sub in ("rgb", "depth", "flow"):
                    (root / sub / f"view_{cam_idx}").mkdir(parents=True, exist_ok=True)
                image_io.write_rgb(root / rel, (rgb * 255).astype(np.uint8))
                # 16-bit png in millimeters (nerfstudio depth convention)
                image_io.write_depth(root / depth_rel, (zdepth * 1000).astype(np.uint16))

                # analytic fwd/bwd flow from the sphere's rigid translation
                for flow_type, other in (("fwd", f + 1), ("bwd", f - 1)):
                    if not (0 <= other < frames_per_traj):
                        continue
                    delta = sphere_center(qpos_all[(traj, other)]) - center
                    uv0 = _project(points, c2w, fx, fy, cx, cy)
                    uv1 = _project(points + delta, c2w, fx, fy, cx, cy)
                    flow = np.where(hit[..., None], uv1 - uv0, 0.0).astype(np.float32)
                    np.savez_compressed(
                        root / f"flow/view_{cam_idx}/{traj:05d}_{f:05d}_{flow_type}.npz",
                        flow=flow,
                    )

                if track_points is None:
                    ys, xs = np.nonzero(hit)
                    if len(ys) > 0:
                        sel = rng_tracks.permutation(len(ys))[:24]
                        track_pts_world = points[ys[sel], xs[sel]]  # on-sphere
                        track_offsets = track_pts_world - center
                        bg_ys, bg_xs = np.nonzero(~hit)
                        neg = rng_tracks.permutation(len(bg_ys))[:16]
                        negative_yx = np.stack(
                            [bg_ys[neg], bg_xs[neg]], -1).astype(np.float32)
                        tracks = np.zeros((len(sel), frames_per_traj, 2), np.float32)
                        visible = np.ones((len(sel), frames_per_traj), np.float32)
                        for t_idx in range(frames_per_traj):
                            c_t = sphere_center(qpos_all[(traj, t_idx)])
                            uv = _project(track_offsets + c_t, c2w, fx, fy, cx, cy)
                            tracks[:, t_idx] = uv
                            inside = ((uv[:, 0] >= 0) & (uv[:, 0] < width)
                                      & (uv[:, 1] >= 0) & (uv[:, 1] < height))
                            visible[:, t_idx] = inside.astype(np.float32)
                        track_points = (tracks, visible, negative_yx)
                        (root / "tapir" / f"view_{cam_idx}").mkdir(
                            parents=True, exist_ok=True)
                if track_points is not None:
                    np.savez_compressed(
                        root / f"tapir/view_{cam_idx}/{traj:05d}_{f:05d}.npz",
                        point_track_data=track_points[0],
                        pixel_visible_mask=track_points[1],
                        negative_yx=track_points[2],
                    )

                frames.append({
                    "file_path": rel,
                    "depth_file_path": depth_rel,
                    "transform_matrix": c2w.tolist(),
                    "time": (traj * frames_per_traj + f) / max(total - 1, 1),
                    "sample_idx": traj,
                    "camera_idx": cam_idx,
                    "joint_pos": q.tolist(),
                })

    with open(root / "transforms.json", "w", encoding="utf-8") as fp:
        json.dump({"cameras": cameras_json, "frames": frames}, fp)
    return root
