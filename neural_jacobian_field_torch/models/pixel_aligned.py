"""Pixel-aligned feature projection (PyTorch counterpart of
models/pixel_aligned.py): world points are projected into the context camera
and bound to their ray's knot textures (epipolar mode, RayKnots) or sampled
from every pyramid level (exact mode, PackedPyramid). The concat layout's
grid_sample branch is not ported."""

from typing import Tuple, Union

import torch

from ..ops.epipolar import KnotFeatures, RayKnots, knot_features
from ..ops.pixel_gather import PackedPyramid, pyramid_pixel_levels
from ..rendering.geometry import homogenize_points, project_z_divide, transform_world2cam


def get_pixel_aligned_features(
        coords_3d_world: torch.Tensor, cam2world: torch.Tensor, intrinsics: torch.Tensor,
        img_features: Union[RayKnots, PackedPyramid],
) -> Tuple[Union[KnotFeatures, Tuple[torch.Tensor, ...]], torch.Tensor, torch.Tensor]:
    """coords_3d_world [B, N, 3], cam2world [B, 4, 4], normalized intrinsics
    [B, 3, 3], and the context features -> (features, camera-space xyz
    [B, N, 3], normalized homogeneous pixel coords [B, N, 3]). The features
    are a lazy KnotFeatures (RayKnots) or the three sampled levels (fine, mid,
    coarse) [B, N, C_l] of a PackedPyramid, whose concatenation in that order
    is the reference's [B, N, 512] feature; the ResnetFC trunks take them
    level by level."""
    if not isinstance(img_features, (RayKnots, PackedPyramid)):
        raise NotImplementedError(
            "only the pyramid feature paths (epipolar RayKnots, exact PackedPyramid) are "
            "ported")
    c3d_cam_hom = transform_world2cam(homogenize_points(coords_3d_world), cam2world[:, None])
    c2d_cam, _ = project_z_divide(c3d_cam_hom, intrinsics[:, None])
    hf, wf = img_features.fine_hw
    fx = c2d_cam[..., 0] * (wf - 1)
    fy = c2d_cam[..., 1] * (hf - 1)
    if isinstance(img_features, RayKnots):
        feats = knot_features(img_features, fx, fy)
    else:
        feats = pyramid_pixel_levels(img_features, fx, fy)
    return feats, c3d_cam_hom[..., :3], c2d_cam
