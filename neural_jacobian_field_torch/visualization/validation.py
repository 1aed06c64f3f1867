"""Validation video rendering (PyTorch counterpart of
visualization/validation.py:render_interpolated_view): interpolate the
target camera towards the context camera with cosine easing, render each
frame through `render_camera` (on the card, its captured programs: the
encoder and the render chunk, captured at the first frame and replayed
after), and colour the depth and flow with scales shared across the
video."""

from typing import Dict, Optional

import numpy as np
import torch

from ..inference.render import depth_colormap, flow_to_rgb, render_camera
from ..models.model import CameraInput, Model, RobotInput
from .view_interpolation import cosine_smooth, interpolate_intrinsics, interpolate_pose


def render_interpolated_view(
        model: Model,
        ctxt_rgb: torch.Tensor,  # [1, H, W, 3], on the model's device
        ctxt_extrinsics: torch.Tensor,  # [1, 4, 4]
        ctxt_intrinsics: torch.Tensor,  # [1, 3, 3] normalized
        trgt_extrinsics: torch.Tensor,
        trgt_intrinsics: torch.Tensor,
        robot_action: torch.Tensor,  # [1, A]
        near: float,
        far: float,
        num_frames: int = 30,
        height: Optional[int] = None,
        width: Optional[int] = None,
        patch_size: int = 2048,
) -> Dict[str, np.ndarray]:
    """Returns {"rgb", "depth", "optical_flow"} uint8 videos [T, H, W, 3]."""
    height = height or ctxt_rgb.shape[1]
    width = width or ctxt_rgb.shape[2]
    dev = ctxt_extrinsics.device

    def host(t):
        return t[0].detach().float().cpu().numpy()

    rgb_frames, depth_raws, flow_raws = [], [], []
    for i in range(num_frames):
        t = cosine_smooth(i / max(num_frames - 1, 1))
        c2w = interpolate_pose(host(trgt_extrinsics), host(ctxt_extrinsics), t)[None]
        intr = interpolate_intrinsics(host(trgt_intrinsics), host(ctxt_intrinsics), t)[None]
        camera_input = CameraInput(
            input_image=ctxt_rgb, ctxt_extrinsics=ctxt_extrinsics,
            ctxt_intrinsics=ctxt_intrinsics,
            trgt_extrinsics=torch.as_tensor(c2w, dtype=ctxt_extrinsics.dtype, device=dev),
            trgt_intrinsics=torch.as_tensor(intr, dtype=ctxt_intrinsics.dtype, device=dev))
        out = render_camera(model, camera_input, RobotInput(robot_action=robot_action),
                            z_near=near, z_far=far, height=height, width=width,
                            patch_size=patch_size)
        rgb_frames.append(out.rgb[0].float().cpu().numpy())
        depth_raws.append(out.depth_raw[0].float().cpu().numpy())
        flow_raws.append(out.flow_raw[0].float().cpu().numpy())

    # colour scales shared across the video
    d_lo = min(d.min() for d in depth_raws)
    d_hi = max(d.max() for d in depth_raws)
    f_max = max(float(np.linalg.norm(f, axis=-1).max()) for f in flow_raws) or 1.0
    return {
        "rgb": (np.clip(np.stack(rgb_frames), 0, 1) * 255).astype(np.uint8),
        "depth": np.stack([depth_colormap(d, near=d_lo, far=d_hi) for d in depth_raws]),
        "optical_flow": np.stack([flow_to_rgb(f, max_norm=f_max) for f in flow_raws]),
    }
