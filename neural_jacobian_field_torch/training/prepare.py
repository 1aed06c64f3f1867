"""Training batch preparation: ray subsampling and target packing
(PyTorch counterpart of training/prepare.py, perception mode).

One random pixel set is shared across the batch; depth targets are divided
by the camera-space z of the unit ray direction (z-depth -> ray distance);
the target intrinsics in CameraInput are denormalized to pixels, so rendered
optical flow is in pixels. RGB may arrive as uint8 (normalized here).
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..models.model import CameraInput, ModelInput, ModelTarget, RenderingInput, RobotInput
from ..rendering.geometry import get_pixel_coordinates, get_world_rays_with_z


@dataclass
class RawBatch:
    """One training batch of whole images, as the host pipeline ships it."""

    ctxt_rgb: torch.Tensor  # [B, H, W, 3] float in [0, 1] or uint8
    ctxt_extrinsics: torch.Tensor  # [B, 4, 4]
    ctxt_intrinsics: torch.Tensor  # [B, 3, 3] normalized
    robot_action: torch.Tensor  # [B, A]
    trgt_rgb: torch.Tensor  # [B, H, W, 3] float in [0, 1] or uint8
    trgt_depth: torch.Tensor  # [B, H, W, 1] z-depth
    trgt_extrinsics: torch.Tensor  # [B, 4, 4]
    trgt_intrinsics: torch.Tensor  # [B, 3, 3] normalized
    near: torch.Tensor  # [B]
    far: torch.Tensor  # [B]


def denormalize_intrinsics(intrinsics: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Normalized [0, 1] intrinsics -> pixel units."""
    scale = torch.tensor([[width, 1.0, width], [1.0, height, height], [1.0, 1.0, 1.0]],
                         dtype=intrinsics.dtype, device=intrinsics.device)
    return intrinsics * scale


def sample_pixels(rays_per_batch: int, height: int, width: int,
                  generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """The shared pixel set: yx [R, 2] int64, uniform over the image."""
    u = torch.rand((rays_per_batch, 2), generator=generator, device=device)
    return (u * torch.tensor([height, width], dtype=torch.float32, device=device)).long()


def prepare_training_batch(batch: RawBatch, rays_per_batch: int,
                           generator: Optional[torch.Generator] = None,
                           yx: Optional[torch.Tensor] = None) -> Tuple[ModelInput, ModelTarget]:
    """Subsample rays at one pixel set shared across the batch (`yx` [R, 2]
    when given, else drawn from `generator`) and pack model inputs/targets."""
    ctxt_rgb, trgt_rgb = batch.ctxt_rgb, batch.trgt_rgb
    if ctxt_rgb.dtype == torch.uint8:
        ctxt_rgb = ctxt_rgb.float() / 255.0
        trgt_rgb = trgt_rgb.float() / 255.0
    b, h, w = trgt_rgb.shape[:3]
    dev = trgt_rgb.device
    if yx is None:
        yx = sample_pixels(rays_per_batch, h, w, generator, dev)
    yx = yx.to(dev).long()
    coords, _ = get_pixel_coordinates(h, w, device=dev)
    coordinates = coords[yx[:, 0], yx[:, 1]].expand(b, -1, -1)
    flat = yx[:, 0] * w + yx[:, 1]
    rgb = trgt_rgb.reshape(b, h * w, 3)[:, flat]
    depth = batch.trgt_depth.reshape(b, h * w, 1)[:, flat]
    origins, directions, z = get_world_rays_with_z(coordinates, batch.trgt_intrinsics,
                                                   batch.trgt_extrinsics)
    model_input = ModelInput(
        camera_input=CameraInput(
            input_image=ctxt_rgb, ctxt_extrinsics=batch.ctxt_extrinsics,
            ctxt_intrinsics=batch.ctxt_intrinsics, trgt_extrinsics=batch.trgt_extrinsics,
            trgt_intrinsics=denormalize_intrinsics(batch.trgt_intrinsics, h, w)),
        rendering_input=RenderingInput(origins=origins, directions=directions,
                                       z_near=batch.near, z_far=batch.far),
        robot_input=RobotInput(robot_action=batch.robot_action))
    return model_input, ModelTarget(rgb=rgb, depth=depth / z)
