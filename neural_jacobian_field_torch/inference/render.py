"""Whole-image chunked rendering (PyTorch counterpart of inference/render.py).

The context image is encoded once; the target camera's rays are then
rendered in fixed-size chunks (2048 rays by default), which bounds memory
the way the JAX package's lax.map does. Everything runs under
torch.no_grad(): serving takes no gradient.

On the card `patch_render` is two captured programs (inference/programs.py),
the counterpart of JAX's one jit: the encoder, replayed once per render into
its static outputs, and one chunk (`_render_chunk`: ray bundle, features,
proposal, decoder, compositing), which reads those outputs in place and is
replayed per chunk: copy the chunk's rays in, replay, copy its eight outputs
into slices of the full-image outputs. On the CPU the same Python runs
eagerly. `render_camera_sharded` splits the rays over the ranks of a
data-parallel mesh and gathers the shares.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..models.decoders import PixelEncoding
from ..models.model import CameraInput, Model, RenderingInput, RobotInput
from ..ops.pixel_gather import features_from_fields
from ..rendering.geometry import get_pixel_coordinates, get_world_rays


@dataclass
class RenderingOutput:
    rgb: torch.Tensor  # [B, H, W, 3]
    depth_raw: torch.Tensor  # [B, H, W, 1]
    flow_raw: torch.Tensor  # [B, H, W, 2]
    action_features: torch.Tensor  # [B, H, W, A*3]
    ray_positions: torch.Tensor  # [B, H, W, 3]
    ray_positions_warped: torch.Tensor  # [B, H, W, 3]
    weights: torch.Tensor  # [B, H, W, S]
    steps: torch.Tensor  # [B, H, W, S]


def camera_rays(height: int, width: int, intrinsics: torch.Tensor,
                cam2world: torch.Tensor):
    """Full-image ray grid for a [B] camera batch -> ([B, H*W, 3] x2)."""
    coords, _ = get_pixel_coordinates(height, width, device=cam2world.device)
    coords = coords.to(cam2world.dtype).reshape(1, height * width, 2)
    coords = coords.expand(cam2world.shape[0], height * width, 2)
    return get_world_rays(coords, intrinsics, cam2world)


def _render_chunk(model: Model, features, ctxt_extrinsics, ctxt_intrinsics, trgt_extrinsics,
                  trgt_intrinsics, action, z_near, z_far, origins, directions) -> tuple:
    """One chunk of rays [B, P, 3] from the encoded context `features`: the
    eight outputs of RenderingOutput, each [B, P, ...]."""
    cam = CameraInput(input_image=None, ctxt_extrinsics=ctxt_extrinsics,
                      ctxt_intrinsics=ctxt_intrinsics, trgt_extrinsics=trgt_extrinsics,
                      trgt_intrinsics=trgt_intrinsics)
    encoding = PixelEncoding(features=features, extrinsics=ctxt_extrinsics,
                             intrinsics=ctxt_intrinsics, action=action)
    ray_bundle = model.compute_ray_bundle(RenderingInput(origins, directions, z_near, z_far))
    out = model.render_rays(encoding, ray_bundle, cam, compute_vis_features=True)
    return (out.rgb, out.depth, out.optical_flow, out.action_features, out.ray_positions,
            out.ray_positions_warped, out.weights, out.steps)


@torch.no_grad()
def patch_render(model: Model, camera_input: CameraInput, rendering_input: RenderingInput,
                 robot_input: RobotInput, patch_size: int = 2048,
                 render_height: int = 480, render_width: int = 640) -> RenderingOutput:
    """Chunked full-image render. The ray count must be a multiple of
    patch_size (render_camera pads it) and at least render_height *
    render_width; the padding rays are dropped."""
    outs = _render_rays(model, camera_input, rendering_input, robot_input, patch_size)
    return _image_output(outs, render_height, render_width)


def _image_output(outs, height: int, width: int) -> RenderingOutput:
    """The eight per-ray outputs [B, rays, ...] cut to height x width rays
    and shaped as images."""

    def unchunk(x):
        x = x[:, :height * width]
        return x.reshape(x.shape[0], height, width, *x.shape[2:])

    return RenderingOutput(*map(unchunk, outs))


def _render_rays(model: Model, camera_input: CameraInput, rendering_input: RenderingInput,
                 robot_input: RobotInput, patch_size: int) -> list:
    """The eight outputs of every ray [B, rays, ...], rendered in chunks of
    patch_size (the ray count a multiple of it): the chunk program's
    replays on the card, eagerly elsewhere."""
    num_rays = rendering_input.origins.shape[1]
    if num_rays % patch_size:
        raise ValueError("pad rays to a multiple of patch_size")
    b = rendering_input.origins.shape[0]
    image = camera_input.input_image
    # per render: the cameras, the action, the depth range; per chunk: the rays
    per_render = (camera_input.ctxt_extrinsics, camera_input.ctxt_intrinsics,
                  camera_input.trgt_extrinsics, camera_input.trgt_intrinsics,
                  robot_input.robot_action, rendering_input.z_near, rendering_input.z_far)
    starts = range(0, num_rays, patch_size)
    rays = [(rendering_input.origins[:, s:s + patch_size],
             rendering_input.directions[:, s:s + patch_size]) for s in starts]
    if model.programs.captures(image):
        # the encoder's static outputs, read in place by the chunk program
        fields = model.features_program(image).replay(image)
        features = features_from_fields(fields)
        chunk = model.programs.get(
            (_render_chunk, model), per_render + rays[0],
            lambda *xs: _render_chunk(model, features, *xs),
            resident=[t for t in fields if isinstance(t, torch.Tensor)])
        outs = [o.new_empty((b, num_rays, *o.shape[2:])) for o in chunk.outputs]
        keep = (None,) * len(per_render)  # already in the static buffers
        for i, (s, chunk_rays) in enumerate(zip(starts, rays)):
            chunk(*(keep if i else per_render), *chunk_rays,
                  out=[o[:, s:s + patch_size] for o in outs])
    else:
        features = model.compute_pixel_encoding(camera_input, robot_input).features
        parts = [_render_chunk(model, features, *per_render, *chunk_rays) for chunk_rays in rays]
        outs = [torch.cat(xs, dim=1) for xs in zip(*parts)]
    return outs


def render_camera(model: Model, camera_input: CameraInput, robot_input: RobotInput,
                  z_near, z_far, height: int, width: int,
                  patch_size: int = 2048) -> RenderingOutput:
    """Render the TARGET camera of camera_input at height x width. Target
    intrinsics that look denormalized (fx > 2) are normalized for the rays."""
    ri = _camera_rendering_input(camera_input, z_near, z_far, height, width, patch_size)
    return patch_render(model, camera_input, ri, robot_input, patch_size=patch_size,
                        render_height=height, render_width=width)


@torch.no_grad()
def render_camera_sharded(model: Model, camera_input: CameraInput, robot_input: RobotInput,
                          z_near, z_far, height: int, width: int, mesh,
                          patch_size: int = 2048) -> RenderingOutput:
    """`render_camera` with the rays sharded over the ranks of `mesh`
    (parallel/mesh.py; the JAX render_camera_sharded): the rays are padded
    to a multiple of ranks x patch_size, each rank encodes the context
    (replicated) and renders its contiguous share of the rays in chunks of
    patch_size, and the shares are gathered to every rank. Volume rendering
    is independent per ray, so nothing else is exchanged."""
    from ..parallel.mesh import all_gather

    ri = _camera_rendering_input(camera_input, z_near, z_far, height, width,
                                 patch_size * mesh.size)
    share = mesh.rows(ri.origins.shape[1], "the padded rays")
    mine = RenderingInput(origins=ri.origins[:, share], directions=ri.directions[:, share],
                          z_near=ri.z_near, z_far=ri.z_far)
    outs = _render_rays(model, camera_input, mine, robot_input, patch_size)
    return _image_output([all_gather(o, mesh, dim=1) for o in outs], height, width)


def _camera_rendering_input(camera_input: CameraInput, z_near, z_far, height: int, width: int,
                            quantum: int) -> RenderingInput:
    """The target camera's rays at height x width, padded (with the first
    rays) to a multiple of `quantum`, and the depth range per camera."""
    cam2world = camera_input.trgt_extrinsics
    b = cam2world.shape[0]
    intr = camera_input.trgt_intrinsics
    # filled on the device (a host tensor copied over would wait for the stream)
    norm = torch.ones((3, 3), dtype=intr.dtype, device=intr.device)
    norm[0, 0::2].fill_(1.0 / width)
    norm[1, 1:].fill_(1.0 / height)
    intr_n = torch.where(intr[:, 0:1, 0:1] > 2.0, intr * norm, intr)
    origins, directions = camera_rays(height, width, intr_n, cam2world)
    n = origins.shape[1]
    pad = (-n) % quantum
    if pad:  # the first rays again, cycled where the image has fewer rays than the pad
        again = torch.arange(pad, device=origins.device) % n
        origins = torch.cat([origins, origins[:, again]], dim=1)
        directions = torch.cat([directions, directions[:, again]], dim=1)

    def per_camera(v):
        if isinstance(v, torch.Tensor):
            return v.to(dtype=origins.dtype, device=origins.device).expand(b)
        return torch.full((b,), float(v), dtype=origins.dtype, device=origins.device)

    return RenderingInput(origins=origins, directions=directions,
                          z_near=per_camera(z_near), z_far=per_camera(z_far))


# -- host-side colormaps (validation frames) ------------------------------------

# the turbo colormap at 33 evenly spaced points (matplotlib's table, 8-bit),
# interpolated where matplotlib is not installed: within 7 levels of it
_TURBO_KNOTS = np.array([
    [48, 18, 59], [57, 42, 115], [64, 64, 162], [68, 86, 199], [70, 107, 227],
    [70, 128, 246], [66, 148, 255], [55, 168, 250], [40, 188, 235], [28, 205, 216],
    [24, 221, 194], [31, 233, 175], [50, 242, 152], [78, 249, 125], [109, 254, 98],
    [139, 255, 75], [164, 252, 60], [185, 246, 53], [205, 236, 52], [223, 223, 55],
    [238, 207, 58], [248, 190, 57], [253, 172, 52], [254, 150, 43], [251, 126, 33],
    [244, 102, 23], [235, 80, 14], [223, 63, 8], [208, 47, 5], [190, 33, 2],
    [169, 22, 1], [146, 11, 1], [122, 4, 3]]) / 255.0


def turbo(x: np.ndarray) -> np.ndarray:
    """The turbo colormap at x in [0, 1] -> [..., 3] floats in [0, 1]:
    matplotlib's where matplotlib is installed, else `_TURBO_KNOTS`
    interpolated linearly."""
    try:
        import matplotlib
    except ImportError:
        knots = np.linspace(0.0, 1.0, len(_TURBO_KNOTS))
        return np.stack([np.interp(x, knots, _TURBO_KNOTS[:, c]) for c in range(3)], -1)
    return matplotlib.colormaps["turbo"](x)[..., :3]


def depth_colormap(depth: np.ndarray, near=None, far=None) -> np.ndarray:
    """Turbo-colormapped depth (nerfstudio apply_depth_colormap): depth
    [..., 1] or [...] -> uint8 [..., 3], scaled to [near, far] (the depth's
    own range by default)."""
    d = np.asarray(depth)
    if d.shape[-1] == 1:
        d = d[..., 0]
    lo = np.min(d) if near is None else near
    hi = np.max(d) if far is None else far
    x = np.clip((d - lo) / (hi - lo + 1e-10), 0, 1)
    return (turbo(x) * 255).astype(np.uint8)


def flow_to_rgb(flow: np.ndarray, max_norm: Optional[float] = None) -> np.ndarray:
    """Optical-flow colour wheel (torchvision flow_to_image semantics: hue
    the direction, saturation the magnitude over max_norm): [..., 2] ->
    uint8 [..., 3]."""
    f = np.asarray(flow, dtype=np.float64)
    mag = np.linalg.norm(f, axis=-1)
    if max_norm is None:
        max_norm = max(float(mag.max()), 1e-8)
    h = (np.arctan2(-f[..., 1], -f[..., 0]) + np.pi) / (2 * np.pi)  # [0, 1)
    sat = np.clip(mag / max_norm, 0, 1)
    # HSV -> RGB at value 1
    i = np.floor(h * 6).astype(int) % 6
    frac = h * 6 - np.floor(h * 6)
    p, q, t = 1 - sat, 1 - sat * frac, 1 - sat * (1 - frac)
    one = np.ones_like(sat)
    lut = np.stack([
        np.stack([one, t, p], -1), np.stack([q, one, p], -1),
        np.stack([p, one, t], -1), np.stack([p, q, one], -1),
        np.stack([t, p, one], -1), np.stack([one, p, q], -1),
    ], 0)
    rgb = np.take_along_axis(lut, i[None, ..., None], axis=0)[0]
    return (rgb * 255).astype(np.uint8)
