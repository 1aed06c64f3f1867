"""Training batch preparation: ray subsampling and target packing
(PyTorch counterpart of training/prepare.py).

One random pixel set is shared across the batch (perception, and action
mode with flow supervision, which takes the flow there); in action mode
with tracks (`pixel_selector` given) each example gathers its own pixels and
the targets are the tracks' motion and visibility. Depth targets are divided
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
    flow: Optional[torch.Tensor] = None  # [B, H, W, 2] (action mode, flow supervision)
    pixel_selector: Optional[torch.Tensor] = None  # [B, N] flat h*w indices (tracks)
    pixel_motion: Optional[torch.Tensor] = None  # [B, N, 2] (tracks)
    pixel_visible_mask: Optional[torch.Tensor] = None  # [B, N] (tracks)


def denormalize_intrinsics(intrinsics: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Normalized [0, 1] intrinsics -> pixel units. The scale is filled on
    the device: no copy from the host."""
    scale = torch.ones((3, 3), dtype=intrinsics.dtype, device=intrinsics.device)
    scale[0, ::2].fill_(width)
    scale[1, 1:].fill_(height)
    return intrinsics * scale


def sample_pixels(rays_per_batch: int, height: int, width: int,
                  generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """The shared pixel set: yx [R, 2] int64, uniform over the image."""
    u = torch.rand((rays_per_batch, 2), generator=generator, device=device)
    hw = torch.full((2,), float(width), device=device)
    hw[0].fill_(height)
    return (u * hw).long()


def prepare_training_batch(batch: RawBatch, rays_per_batch: int,
                           generator: Optional[torch.Generator] = None,
                           yx: Optional[torch.Tensor] = None,
                           mode: str = "perception") -> Tuple[ModelInput, ModelTarget]:
    """Subsample rays and pack model inputs/targets. mode "perception" or
    "action"; in action mode the targets carry the flow at the rays, or,
    when `batch.pixel_selector` is given, the rays are the tracks' pixels of
    each example, with their motion and visibility mask. Otherwise one pixel
    set is shared across the batch: `yx` [R, 2] when given, else drawn from
    `generator`."""
    if mode not in ("perception", "action"):
        raise ValueError(f"unknown mode {mode!r}")
    ctxt_rgb, trgt_rgb = batch.ctxt_rgb, batch.trgt_rgb
    if ctxt_rgb.dtype == torch.uint8:
        ctxt_rgb = ctxt_rgb.float() / 255.0
        trgt_rgb = trgt_rgb.float() / 255.0
    b, h, w = trgt_rgb.shape[:3]
    dev = trgt_rgb.device
    coords, _ = get_pixel_coordinates(h, w, device=dev)
    rgb_flat = trgt_rgb.reshape(b, h * w, 3)
    depth_flat = batch.trgt_depth.reshape(b, h * w, 1)
    flow, visible = None, None
    if mode == "action" and batch.pixel_selector is not None:
        sel = batch.pixel_selector.to(dev).long()  # [B, N], per example

        def take(x):
            return torch.gather(x, 1, sel[..., None].expand(-1, -1, x.shape[-1]))

        rgb, depth = take(rgb_flat), take(depth_flat)
        coordinates = take(coords.reshape(1, h * w, 2).expand(b, -1, -1))
        flow, visible = batch.pixel_motion, batch.pixel_visible_mask
    else:
        if yx is None:
            yx = sample_pixels(rays_per_batch, h, w, generator, dev)
        yx = yx.to(dev).long()
        coordinates = coords[yx[:, 0], yx[:, 1]].expand(b, -1, -1)
        flat = yx[:, 0] * w + yx[:, 1]
        rgb, depth = rgb_flat[:, flat], depth_flat[:, flat]
        if mode == "action":
            flow = batch.flow.reshape(b, h * w, 2)[:, flat]
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
    return model_input, ModelTarget(rgb=rgb, depth=depth / z, optical_flow=flow,
                                    visible_mask=visible)
