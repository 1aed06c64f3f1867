"""Camera / ray geometry (PyTorch counterpart of rendering/geometry.py).

Conventions as in the JAX package: intrinsics are *normalized* (pixel coords
in [0, 1]) unless stated, extrinsics are OpenCV camera-to-world 4x4, the
projection z-divides with eps 1e-9. The JAX package pins these einsums to
full f32 precision; here they are plain f32 products, which are full
precision on the card as long as TF32 matmuls stay off (PyTorch's default).
"""

import torch


def homogenize_points(points: torch.Tensor) -> torch.Tensor:
    """(..., n) xyz -> (..., n+1) xyz1."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def homogenize_vecs(vectors: torch.Tensor) -> torch.Tensor:
    """(..., n) xyz -> (..., n+1) xyz0."""
    return torch.cat([vectors, torch.zeros_like(vectors[..., :1])], dim=-1)


def transform_rigid(homogeneous_xyz: torch.Tensor,
                    transformation: torch.Tensor) -> torch.Tensor:
    """Apply 4x4 transforms: [..., i, j] @ [..., j]."""
    return torch.einsum("...ij,...j->...i", transformation, homogeneous_xyz)


def inverse(a: torch.Tensor) -> torch.Tensor:
    """Matrix inverse that, like jnp.linalg.inv, does not check for a singular
    matrix (torch.linalg.inv's check reads a flag back on the host: a stream
    sync, and an error inside a CUDA graph capture)."""
    return torch.linalg.inv_ex(a).inverse


def transform_world2cam(homogeneous_world_xyz: torch.Tensor,
                        cam2world: torch.Tensor) -> torch.Tensor:
    return transform_rigid(homogeneous_world_xyz, inverse(cam2world))


def transform_cam2world(homogeneous_cam_xyz: torch.Tensor,
                        cam2world: torch.Tensor) -> torch.Tensor:
    return transform_rigid(homogeneous_cam_xyz, cam2world)


def unproject(coordinates_xy: torch.Tensor, z: torch.Tensor,
              intrinsics: torch.Tensor) -> torch.Tensor:
    """Unproject normalized 2D coords at depth z. coordinates_xy [B, N, 2];
    z [B, N]; intrinsics [B, 3, 3]."""
    coords_h = homogenize_points(coordinates_xy)
    k_inv = inverse(intrinsics)
    coords_xyz = torch.einsum("bij,bnj->bni", k_inv, coords_h)
    return coords_xyz * z[..., None]


def project_z_divide(xyz_cam_hom: torch.Tensor, intrinsics: torch.Tensor,
                     eps: float = 1e-9):
    """Homogeneous camera-space points -> pixel coords. Returns (xyw[..., 3], z)."""
    xyw = torch.einsum("...ij,...j->...i", intrinsics, xyz_cam_hom[..., :3])
    return z_divide(xyw, eps), xyw[..., -1:]


def z_divide(xyw: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Homogeneous pixel coordinates [..., 3] over their last (z + eps)."""
    return xyw / (xyw[..., -1:] + eps)


def get_world_rays(coordinates_xy: torch.Tensor, intrinsics: torch.Tensor,
                   cam2world: torch.Tensor):
    """Normalized pixel coords [B, N, 2] -> world (origins, unit directions)."""
    origins, directions, _ = get_world_rays_with_z(coordinates_xy, intrinsics, cam2world)
    return origins, directions


def get_world_rays_with_z(coordinates_xy: torch.Tensor, intrinsics: torch.Tensor,
                          cam2world: torch.Tensor):
    """Like get_world_rays, plus the camera-space direction z component.
    Returns origins [B, N, 3], directions [B, N, 3], z [B, N, 1]."""
    origins = cam2world[..., :3, 3]
    directions = unproject(coordinates_xy, torch.ones_like(coordinates_xy[..., 0]),
                           intrinsics)
    directions = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)
    z = directions[..., -1:]
    directions = homogenize_vecs(directions)
    directions = transform_cam2world(directions, cam2world[:, None])
    num_rays = directions.shape[1]
    origins = origins[:, None, :].expand(*origins.shape[:-1], num_rays, 3)
    return origins, directions[..., :3], z


def get_pixel_coordinates(height: int, width: int, device=None):
    """Normalized (pixel-center) xy grid + integer yx selector grid.
    Returns (coordinates [H, W, 2] float32, selector [H, W, 2] int64)."""
    row = torch.arange(height, device=device)
    col = torch.arange(width, device=device)
    selector = torch.stack(torch.meshgrid(row, col, indexing="ij"), dim=-1)
    x = (col + 0.5) / width
    y = (row + 0.5) / height
    coordinates = torch.stack(torch.meshgrid(x, y, indexing="xy"), dim=-1)
    return coordinates.to(torch.float32), selector


def project_world_coords_to_camera(coords_3d_world: torch.Tensor,
                                   cam2world: torch.Tensor,
                                   intrinsics: torch.Tensor) -> torch.Tensor:
    """World points [B, N, 3] -> pixel coords [B, N, 2] in the units of
    `intrinsics`."""
    c3d_hom = homogenize_points(coords_3d_world)
    c3d_cam = transform_world2cam(c3d_hom, cam2world[..., None, :, :])
    c2d, _ = project_z_divide(c3d_cam, intrinsics[..., None, :, :])
    return c2d[..., :2]


def compute_focus_point(ray_origins: torch.Tensor,
                        ray_directions: torch.Tensor) -> torch.Tensor:
    """Least-squares intersection of rays [N, 3] -> [3]."""
    n = torch.einsum("...i,...j->...ij", ray_directions, ray_directions)
    n = n - torch.eye(3, dtype=ray_origins.dtype, device=ray_origins.device)[None]
    lhs = n.sum(dim=0)
    rhs = torch.einsum("bij,bj->bi", n, ray_origins).sum(dim=0)
    return torch.linalg.pinv(lhs) @ rhs
