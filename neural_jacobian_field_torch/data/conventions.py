"""On-disk and coordinate conventions (host-side NumPy; the port's copy of
data/conventions.py): the OpenCV camera flip, min-max normalization, the
flow and track filename codecs, intrinsics (de)normalization."""

import glob
from typing import Tuple

import numpy as np


def post_process_camera_to_world(c2w: np.ndarray) -> np.ndarray:
    """OpenGL cam2world -> OpenCV: flip the y/z axes (convention.py:9-13)."""
    conversion = np.eye(4, dtype=np.float32)
    conversion[1:3, 1:3] *= -1
    return c2w @ conversion


def normalize(curr_vals, old_min, old_max, new_min=0.0, new_max=1.0):
    """Min-max renormalization (convention.py:16-19)."""
    values = (curr_vals - old_min) / (old_max - old_min)
    return (new_max - new_min) * values + new_min


def get_traj_and_frame_idx(image_filename: str) -> Tuple[int, int]:
    """'.../rgb/view_K/TTTTT_FFFFF.png' -> (traj, frame) (convention.py:55-62)."""
    name = str(image_filename).split("/")[-1]
    traj_idx, frame_idx = name.split("_")
    return int(traj_idx), int(frame_idx.split(".")[0])


def get_optical_flow_filename(image_filename: str, traj_idx: int, frame_idx: int,
                              flow_type: str) -> str:
    """convention.py:65-75; flow_type in {fwd, bwd}."""
    return str(image_filename).replace("rgb", "flow").replace(
        f"{traj_idx:05d}_{frame_idx:05d}.png",
        f"{traj_idx:05d}_{frame_idx:05d}_{flow_type}.npz",
    )


def get_tracking_data_filenames(image_filename: str, traj_idx: int, frame_idx: int):
    """convention.py:90-99."""
    pattern = str(image_filename).replace("rgb", "tapir").replace(
        f"{traj_idx:05d}_{frame_idx:05d}.png", f"{traj_idx:05d}_*.npz"
    )
    return glob.glob(pattern)


def get_trgt_view_filename(ctxt_img_filename: str, ctxt_cam_idx: int,
                           trgt_cam_idx: int) -> str:
    """Pair context/target frames by the view_{i} path convention
    (convention.py:102-108)."""
    return str(ctxt_img_filename).replace(f"view_{ctxt_cam_idx}", f"view_{trgt_cam_idx}")


def normalize_intrinsics(intrinsics: np.ndarray, height: int, width: int) -> np.ndarray:
    """Pixel-unit intrinsics -> [0,1]-normalized (dataset.py:287-301)."""
    out = np.array(intrinsics, dtype=np.float32)
    out[..., 0, :] /= width
    out[..., 1, :] /= height
    return out


def denormalize_intrinsics(intrinsics: np.ndarray, height: int, width: int) -> np.ndarray:
    """convention.py:110-125."""
    out = np.array(intrinsics, dtype=np.float32)
    out[..., 0, :] *= width
    out[..., 1, :] *= height
    return out
