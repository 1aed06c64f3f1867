"""nerfstudio-format `transforms.json` parser, D-NeRF variant (host-side
NumPy; the port's copy of data/dataparser.py): frames carry `time`,
`camera_idx`, `joint_pos`, `depth_file_path`, `mask_path`; cameras[] are
decoupled from frames[]; poses are auto-oriented ("up"), centred ("focus"
by default here) and auto-scaled to the unit box."""

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import numpy as np


@dataclass
class DataparserOutputs:
    """Parsed scene (config_parser.py:44-48 + nerfstudio DataparserOutputs)."""

    image_filenames: List[Path]
    depth_filenames: List[Path]
    mask_filenames: List[Path]
    cam2worlds: np.ndarray  # [num_cameras, 4, 4] (OpenGL, oriented+centered+scaled)
    intrinsics: np.ndarray  # [num_cameras, 3, 3] pixel units (after downscale)
    heights: np.ndarray  # [num_cameras]
    widths: np.ndarray  # [num_cameras]
    sample_to_camera_idx: np.ndarray  # [num_samples]
    times: np.ndarray  # [num_samples]
    joint_positions: Dict[str, np.ndarray]  # keyname -> qpos
    dataparser_scale: float
    depth_unit_scale_factor: float = 1e-3


@dataclass
class DataparserConfig:
    """config_parser.py:51-74 defaults."""

    data: Path = Path(".")
    scale_factor: float = 1.0
    downscale_factor: int = 1
    scene_scale: float = 1.0
    orientation_method: str = "up"  # pca | up | vertical | none
    center_method: str = "poses"  # poses | focus | none
    auto_scale_poses: bool = True
    depth_unit_scale_factor: float = 1e-3


def _focus_of_attention(poses: np.ndarray, initial: np.ndarray) -> np.ndarray:
    """Least-squares closest point to all optical axes (nerfstudio
    camera_utils.focus_of_attention; cameras look along -z in OpenGL)."""
    directions = -poses[:, :3, 2:3]  # [N, 3, 1]
    m = np.eye(3)[None] - directions * directions.transpose(0, 2, 1)
    mt_m = m.transpose(0, 2, 1) @ m
    origins = poses[:, :3, 3:4]
    return (np.linalg.inv(mt_m.mean(0)) @ (mt_m @ origins).mean(0))[:, 0]


def _rotation_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation taking unit vector a to unit vector b (Rodrigues)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(a @ b)
    if np.linalg.norm(v) < 1e-8:
        if c > 0:
            return np.eye(3)
        # antiparallel: rotate 180 deg around any orthogonal axis
        axis = np.cross(a, np.array([1.0, 0.0, 0.0]))
        if np.linalg.norm(axis) < 1e-8:
            axis = np.cross(a, np.array([0.0, 1.0, 0.0]))
        axis /= np.linalg.norm(axis)
        return 2.0 * np.outer(axis, axis) - np.eye(3)
    skew = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + skew + skew @ skew * (1.0 / (1.0 + c))


def auto_orient_and_center_poses(poses: np.ndarray, method: str = "up",
                                 center_method: str = "focus") -> np.ndarray:
    """nerfstudio camera_utils.auto_orient_and_center_poses (NumPy).

    poses: [N, 4, 4] OpenGL cam2world. Returns oriented+centered poses.
    """
    origins = poses[:, :3, 3]
    mean_origin = origins.mean(0)
    if center_method == "poses":
        translation = mean_origin
    elif center_method == "focus":
        translation = _focus_of_attention(poses, mean_origin)
    elif center_method == "none":
        translation = np.zeros(3)
    else:
        raise ValueError(center_method)

    if method in ("up", "vertical"):
        up = poses[:, :3, 1].mean(0)
        up = up / np.linalg.norm(up)
        if method == "vertical":
            # nerfstudio camera_utils: estimate the true vertical as the
            # direction most orthogonal to all camera x-axes (third right-
            # singular vector), if it is well determined; keep the sign
            # aligned with the mean up vector.
            x_axes = poses[:, :3, 0]
            _, s, vh = np.linalg.svd(x_axes, full_matrices=False)
            if s[1] > 0.17 * np.sqrt(len(poses)):
                vertical = vh[2, :]
                up = vertical if float(vertical @ up) > 0 else -vertical
        rotation = _rotation_between(up, np.array([0.0, 0.0, 1.0]))
    elif method == "pca":
        # nerfstudio camera_utils: principal axes of the camera origins.
        diffs = origins - mean_origin
        _, eigvec = np.linalg.eigh(diffs.T @ diffs)
        eigvec = np.flip(eigvec, axis=-1).copy()
        if np.linalg.det(eigvec) < 0:
            eigvec[:, 2] = -eigvec[:, 2]
        rotation = eigvec.T
    elif method == "none":
        rotation = np.eye(3)
    else:
        raise ValueError(f"orientation method {method} not supported")

    transform = np.concatenate([rotation, rotation @ -translation[:, None]], axis=-1)
    oriented = np.einsum("ij,njk->nik", transform, poses)
    if method == "pca" and oriented[:, 2, 1].mean() < 0:
        # keep the mean camera up pointing to +Z (nerfstudio flips y and z)
        oriented[:, 1:3] = -oriented[:, 1:3]
    out = np.broadcast_to(np.eye(4), (len(poses), 4, 4)).copy()
    out[:, :3, :4] = oriented[:, :3, :4]
    return out.astype(np.float32)


def parse_transforms(cfg: DataparserConfig) -> DataparserOutputs:
    """Parse <data>/transforms.json (config_parser.py:87-413)."""
    data = Path(cfg.data)
    if data.suffix == ".json":
        meta_path, data_dir = data, data.parent
    else:
        meta_path, data_dir = data / "transforms.json", data
    with open(meta_path, encoding="utf-8") as f:
        meta = json.load(f)

    image_filenames, depth_filenames, mask_filenames = [], [], []
    times, sample_to_camera_idx = [], []
    joint_positions: Dict[str, np.ndarray] = {}

    for frame in meta["frames"]:
        fname = data_dir / Path(frame["file_path"])
        image_filenames.append(fname)
        times.append(float(frame.get("time", 0.0)))
        sample_to_camera_idx.append(int(frame["camera_idx"]))
        if "depth_file_path" in frame:
            depth_filenames.append(data_dir / Path(frame["depth_file_path"]))
        if "mask_path" in frame:
            mask_filenames.append(data_dir / Path(frame["mask_path"]))
        if "joint_pos" in frame:
            keyname = fname.name[: -len(fname.suffix)]
            if keyname not in joint_positions:
                joint_positions[keyname] = np.asarray(
                    frame["joint_pos"], dtype=np.float32
                ).squeeze()

    def fixed(key):
        return meta.get(key)

    poses, fx, fy, cx, cy, hh, ww = [], [], [], [], [], [], []
    for cam in meta["cameras"]:
        poses.append(np.asarray(cam["transform_matrix"], dtype=np.float32))
        fx.append(float(cam["fl_x"]) if "fl_x" in cam else float(fixed("fl_x")))
        fy.append(float(cam["fl_y"]) if "fl_y" in cam else float(fixed("fl_y")))
        cx.append(float(cam["cx"]) if "cx" in cam else float(fixed("cx")))
        cy.append(float(cam["cy"]) if "cy" in cam else float(fixed("cy")))
        hh.append(int(cam["h"]) if "h" in cam else int(fixed("h")))
        ww.append(int(cam["w"]) if "w" in cam else int(fixed("w")))

    poses = np.stack(poses).astype(np.float32)
    orientation = meta.get("orientation_override", cfg.orientation_method)
    poses = auto_orient_and_center_poses(poses, orientation, cfg.center_method)

    scale_factor = 1.0
    if cfg.auto_scale_poses:
        scale_factor /= float(np.max(np.abs(poses[:, :3, 3])))
    scale_factor *= cfg.scale_factor
    if "applied_scale" in meta:
        scale_factor *= float(meta["applied_scale"])
    poses[:, :3, 3] *= scale_factor

    ds = cfg.downscale_factor
    intrinsics = np.zeros((len(poses), 3, 3), dtype=np.float32)
    intrinsics[:, 0, 0] = np.asarray(fx) / ds
    intrinsics[:, 1, 1] = np.asarray(fy) / ds
    intrinsics[:, 0, 2] = np.asarray(cx) / ds
    intrinsics[:, 1, 2] = np.asarray(cy) / ds
    intrinsics[:, 2, 2] = 1.0

    return DataparserOutputs(
        image_filenames=image_filenames,
        depth_filenames=depth_filenames,
        mask_filenames=mask_filenames,
        cam2worlds=poses,
        intrinsics=intrinsics,
        heights=(np.asarray(hh) // ds).astype(np.int32),
        widths=(np.asarray(ww) // ds).astype(np.int32),
        sample_to_camera_idx=np.asarray(sample_to_camera_idx, dtype=np.int64),
        times=np.asarray(times, dtype=np.float32),
        joint_positions=joint_positions,
        dataparser_scale=scale_factor,
        depth_unit_scale_factor=cfg.depth_unit_scale_factor,
    )


def merge_dataparser_outputs(outputs: List[DataparserOutputs]) -> DataparserOutputs:
    """Multi-root merge (config_parser.py:430-536 + io_utils.combine_roots):
    concatenates samples; cameras come from the first root (reference
    behavior: `cameras=outputs[0].cameras`). Per-sample qpos vectors are
    zero-padded to the longest root's action dimension
    (io_utils.combine_roots:202-218), so robots with differing DoF counts can
    be merged into one action space."""
    first = outputs[0]
    max_len = max(
        (len(next(iter(o.joint_positions.values()))) if o.joint_positions else 0)
        for o in outputs
    )
    joint_positions = {}
    for o in outputs:
        for key, value in o.joint_positions.items():
            value = np.asarray(value)
            if len(value) < max_len:
                value = np.concatenate(
                    [value, np.zeros(max_len - len(value), dtype=value.dtype)]
                )
            joint_positions[key] = value
    return DataparserOutputs(
        image_filenames=sum([o.image_filenames for o in outputs], []),
        depth_filenames=sum([o.depth_filenames for o in outputs], []),
        mask_filenames=sum([o.mask_filenames for o in outputs], []),
        cam2worlds=first.cam2worlds,
        intrinsics=first.intrinsics,
        heights=first.heights,
        widths=first.widths,
        sample_to_camera_idx=np.concatenate([o.sample_to_camera_idx for o in outputs]),
        times=np.concatenate([o.times for o in outputs]),
        joint_positions=joint_positions,
        dataparser_scale=first.dataparser_scale,
        depth_unit_scale_factor=first.depth_unit_scale_factor,
    )
