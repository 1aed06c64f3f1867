"""The plain reference of the exact feature path (`pixel_feature_mode:
"exact"`): every sample point is projected into the context camera and reads
its own bilinear feature from each level of the ResNet-34 pyramid, as
PixelNeRF conditions its field (the source's
`models/model_components/pixel_aligned_features.py:11-35`); the trunks take
that 512-channel latent through their `lin_z` layers. Float32 with TF32 off
(the caller's), no kernel of the program under test: the encoder, the
heads, the sampler, the losses and Adam are model.py's and steps.py's.

Departures from the source, each one the program's too:
- The pyramid layout: fine = conv1 ++ up2(layer1) at conv1's resolution
  (128 channels), mid = layer2 (128) and coarse = layer3 (256) at their own
  resolutions, each level sampled at the sample's own pixel. The source
  upsamples every level to the fine resolution and samples the one
  concatenated 512-channel map (its `grid_sample`, align_corners=True, border
  padding); reading each level at its own resolution is a different
  approximation of the same lookup.
- A level's pixel coordinates are the fine pixel's, c = (f + 0.5) / s - 0.5
  on both axes with s the level's stride, ceil(H_fine / H_level) (1 on the
  fine level, which takes f itself), border-clamped, and bilinear with
  align_corners=True on that level.
- Stage 1 only (the cell's mode): the Jacobian head is not evaluated, as a
  stage-1 step renders no flow.
"""

from typing import Dict, Sequence

import torch

from .model import bilinear, encode, positional_encoding, project, render_weights, world_to_cam
from .steps import Adam, Field, StepInputs, _rays_and_targets, anneal_at, perception_loss


def level_coords(f: torch.Tensor, stride: int) -> torch.Tensor:
    """Fine-level pixel coordinates -> those of a level `stride` times
    coarser."""
    return f if stride == 1 else (f + 0.5) / stride - 0.5


def pyramid_features(pyramid: Sequence[torch.Tensor], fx: torch.Tensor,
                     fy: torch.Tensor) -> torch.Tensor:
    """Each level [B, H_l, W_l, C_l] sampled at the fine-level pixel
    coordinates fx, fy [B, N], levels concatenated in order -> [B, N, sum C_l]."""
    hf = pyramid[0].shape[1]
    out = []
    for level in pyramid:
        stride = (hf + level.shape[1] - 1) // level.shape[1]
        out.append(bilinear(level, level_coords(fx, stride), level_coords(fy, stride)))
    return torch.cat(out, dim=-1)


class ExactField(Field):
    """Field whose points read the pyramid at their own pixels: `sample` and
    the heads take the pyramid where Field takes ray knots."""

    def point_inputs(self, pyramid, positions, ctx_ext, ctx_intr):
        """positions [B, R, S, 3] -> (latent [B, R*S, 512], encoded camera-space
        coordinates [B, R*S, 63])."""
        b, r, s = positions.shape[:3]
        x = positions.reshape(b, r * s, 3)
        cam = world_to_cam(x, ctx_ext[:, None])
        uv = project(cam, ctx_intr[:, None])
        hf, wf = pyramid[0].shape[1:3]
        z = pyramid_features(pyramid, uv[..., 0] * (wf - 1), uv[..., 1] * (hf - 1))
        return z, positional_encoding(cam, self.act["num_frequencies"])


def train_step(field: Field, opt: Adam, x: StepInputs, updated: bool, mode: str,
               loss_cfg: dict) -> float:
    """One stage-1 step in place on field.p and opt, as steps.train_step takes
    it, with the per-sample lookups: the forward in training mode, the
    perception loss, its gradient, Adam. Returns the loss."""
    if mode != "perception":
        raise ValueError(f"the exact reference trains stage 1 only, not {mode!r}")
    p, cfg = field.p, field.cfg
    names = opt.names
    leaves = {n: p[n].detach().requires_grad_(n in names) for n in p}
    f = ExactField(cfg, leaves, field.q)
    updates: Dict[str, torch.Tensor] = {}
    rays, t_rgb, t_depth, _ = _rays_and_targets(x)
    b, r = rays.near.shape
    s = cfg["rendering"]["num_nerf_samples"]
    pyr = tuple(field.q(t) for t in encode(leaves, x.ctxt_rgb, cfg["encoder"]["num_layers"],
                                           True, field.q, updates))
    final, levels = f.sample(pyr, rays, x.ctxt_extrinsics, x.ctxt_intrinsics, x.draws, updated,
                             anneal_at(opt.count, cfg["rendering"]))
    pos = final.positions(rays.origins, rays.directions)
    z, pe = f.point_inputs(pyr, pos, x.ctxt_extrinsics, x.ctxt_intrinsics)
    density, feats = f.density_head(z, pe)
    weights = render_weights(density.reshape(b, r, s), final.deltas)
    color = f.color(feats, rays.directions, s).reshape(b, r, s, 3)
    rgb = torch.sum(weights[..., None] * color, dim=-2)
    loss = perception_loss(levels, final, weights, rgb, t_rgb, t_depth, loss_cfg)
    grads = torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)
    grads = {n: (torch.zeros_like(p[n]) if g is None else g.detach())
             for n, g in zip(names, grads)}
    with torch.no_grad():
        opt.step(p, grads)
        for k, v in updates.items():
            p[k].copy_(v)
    return float(loss.detach())

