"""The reference's rendering, losses, train steps and control step (plain
float32 PyTorch; see model.py)."""

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch

from .model import (
    Precision, Samples, encode, knot_features, linear, pixel_rays, positional_encoding, project,
    ray_knots, rays_from_coords, render_weights, resample, samples_from_bins, sh_deg4,
    spaced_bins, to_pixels, trainable, transformer_jacobian, trunc_exp, trunk, world_to_cam)

RAY_CHUNK = 256  # rays a backward of the action head covers at a time


@dataclass
class Rays:
    origins: torch.Tensor  # [B, R, 3]
    directions: torch.Tensor
    near: torch.Tensor  # [B, R]
    far: torch.Tensor


class Field:
    """The model of one configuration over a parameter dict, at a precision."""

    def __init__(self, model: dict, params: Dict[str, torch.Tensor], q: Precision):
        self.cfg, self.p, self.q = model, params, q
        self.act = model["action_decoder"]
        self.rendering = model["rendering"]

    # features of points
    def point_inputs(self, knots, positions, ctx_ext, ctx_intr):
        """positions [B, R, S, 3] -> (latent [B, R*S, C], encoded camera-space
        coordinates [B, R*S, 63])."""
        b, r, s = positions.shape[:3]
        x = positions.reshape(b, r * s, 3)
        cam = world_to_cam(x, ctx_ext[:, None])
        uv = project(cam, ctx_intr[:, None])
        hf, wf = knots.fine_hw
        z = knot_features(knots, uv[..., 0] * (wf - 1), uv[..., 1] * (hf - 1))
        return z, positional_encoding(cam, self.act["num_frequencies"])

    def proposal_density(self, i, z, pe, shape):
        raw = trunk(self.p, f"proposal_networks_{i}.density_head",
                    self.cfg["density_decoder"]["mlp"], self.q(z), pe, self.q)
        return trunc_exp(raw[..., 0] - 1.0).reshape(shape)

    def density_head(self, z, pe):
        raw = trunk(self.p, "decoder.density_head", self.act["mlp"], self.q(z), pe, self.q)
        geo = self.act["geometry_feature_dim"]
        return trunc_exp(raw[..., geo] - 1.0), raw[..., :geo]

    def color(self, features, directions, s):
        b, r = directions.shape[:2]
        d = ((directions + 1.0) / 2.0) * 2.0 - 1.0
        sh = sh_deg4(d)[:, :, None].expand(b, r, s, 16).reshape(b, r * s, 16)
        x = torch.cat([features, sh], dim=-1)
        x = torch.relu(linear(self.p, "decoder.color_head.fc1", x, self.q))
        x = torch.relu(linear(self.p, "decoder.color_head.fc2", x, self.q))
        return torch.sigmoid(linear(self.p, "decoder.color_head.fc3", x, self.q))

    def jacobian(self, z, pe):
        if self.act["name"] == "jacobian_mlp":
            return trunk(self.p, "decoder.jacobian_head", self.act["mlp"], self.q(z), pe, self.q)
        return transformer_jacobian(self.p, self.act["transformer"],
                                    torch.cat([pe, self.q(z)], dim=-1), self.q)

    # sampling
    def sample(self, knots, rays: Rays, ctx_ext, ctx_intr, draws, updated: bool,
               anneal: float = 1.0):
        """Proposal sampling: (final samples, [(samples, weights)] of the
        proposal levels), the proposal weights raised to `anneal` before
        each resampling. draws None: the deterministic bins."""
        rc = self.rendering
        b, r = rays.near.shape
        levels = []
        samples = weights = None
        counts = list(rc["num_proposal_samples"]) + [rc["num_nerf_samples"]]
        for i, n in enumerate(counts):
            jitter = None if draws is None else draws[i]
            if i == 0:
                bins = spaced_bins((b, r), n, jitter, rays.near.device)
            else:
                bins = resample(samples.bins.detach(), weights.detach() ** anneal, n, jitter)
            samples = samples_from_bins(bins, rays.near, rays.far)
            if i < len(counts) - 1:
                pos = samples.positions(rays.origins, rays.directions)
                with torch.set_grad_enabled(updated and torch.is_grad_enabled()):
                    z, pe = self.point_inputs(knots, pos, ctx_ext, ctx_intr)
                    density = self.proposal_density(i, z, pe, (b, r, n))
                    weights = render_weights(density, samples.deltas)
                levels.append((samples, weights))
        return samples, levels


def composite_flow(weights, positions, scene_flow, trgt_ext, trgt_intr_px):
    """Optical flow [B, R, 2] of composited positions moved by scene_flow."""
    w = weights[..., None]
    pos = torch.sum(w * positions, dim=-2)
    warped = torch.sum(w * (positions + scene_flow), dim=-2)

    def uv(x):
        return project(world_to_cam(x, trgt_ext[:, None]), trgt_intr_px[:, None])[..., :2]

    return uv(warped) - uv(pos)


# ---------------------------------------------------------------------- losses

def outer_measure(t0, t1, y1):
    cy1 = torch.cat([torch.zeros_like(y1[..., :1]), torch.cumsum(y1, dim=-1)], dim=-1)
    last = y1.shape[-1] - 1
    lo = torch.clamp(torch.searchsorted(t1[..., :-1].contiguous(), t0[..., :-1].contiguous(),
                                        right=True) - 1, 0, last)
    hi = torch.clamp(torch.searchsorted(t1[..., 1:].contiguous(), t0[..., 1:].contiguous(),
                                        right=True), 0, last)
    return torch.gather(cy1, -1, hi + 1) - torch.gather(cy1, -1, lo)


def perception_loss(levels, final: Samples, weights, rgb, target_rgb, target_depth, loss_cfg):
    """rgb MSE + depth (DS-NeRF, mean over levels) + interlevel + distortion."""
    rgb_loss = torch.mean((rgb - target_rgb) ** 2)
    all_levels = levels + [(final, weights)]
    depth = 0.0
    for s, w in all_levels:
        steps = (s.starts + s.ends) / 2
        term = (-torch.log(w + 1e-7)
                * torch.exp(-((steps - target_depth) ** 2) / (2 * loss_cfg["depth_sigma"]))
                * s.deltas)
        depth = depth + torch.mean(torch.sum(term, dim=-1, keepdim=True)
                                   * (target_depth > 0)) / len(all_levels)
    c, wf = final.bins.detach(), weights.detach()
    inter = 0.0
    for s, w in levels:
        w_outer = outer_measure(c, s.bins, w)
        inter = inter + torch.mean(torch.clamp(wf - w_outer, min=0.0) ** 2 / (wf + 1.1920929e-07))
    t, w = final.bins, weights
    m = (t[..., 1:] + t[..., :-1]) / 2.0
    cw, cwm = torch.cumsum(w, dim=-1), torch.cumsum(w * m, dim=-1)
    dist = torch.mean(2.0 * torch.sum(w * (m * (cw - w) - (cwm - w * m)), dim=-1)
                      + torch.sum(w ** 2 * (t[..., 1:] - t[..., :-1]), dim=-1) / 3.0)
    return (rgb_loss + loss_cfg["depth_weight"] * depth
            + loss_cfg["interlevel_weight"] * inter + loss_cfg["distortion_weight"] * dist)


# ----------------------------------------------------------------- optimizer

class Adam:
    """optax: decayed weights added to the gradient, Adam's moments, the
    linear warm-up schedule read at the count before the step."""

    def __init__(self, names: Sequence[str], params, lr, warm_up_steps, count,
                 weight_decay=1e-5, b1=0.9, b2=0.999, eps=1e-8):
        self.names = list(names)
        self.m = {n: torch.zeros_like(params[n]) for n in self.names}
        self.v = {n: torch.zeros_like(params[n]) for n in self.names}
        self.lr, self.warm, self.count = lr, warm_up_steps, float(count)
        self.wd, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps

    @torch.no_grad()
    def step(self, params, grads):
        c = torch.tensor(self.count, dtype=torch.float32)
        frac = 1 - torch.clamp(c, 0, self.warm) / self.warm
        lr = float((self.lr / self.warm - self.lr) * frac + self.lr)
        bc1 = float(1 - torch.tensor(self.b1, dtype=torch.float32) ** (c + 1))
        bc2 = float(1 - torch.tensor(self.b2, dtype=torch.float32) ** (c + 1))
        for n in self.names:
            p, g = params[n], grads[n]
            u = g + self.wd * p
            self.m[n].mul_(self.b1).add_((1 - self.b1) * u)
            self.v[n].mul_(self.b2).add_((1 - self.b2) * u * u)
            p.add_(-lr * (self.m[n] / bc1) / (torch.sqrt(self.v[n] / bc2) + self.eps))
        self.count += 1


# ----------------------------------------------------------------- train step

@dataclass
class StepInputs:
    """One step's batch (the program's RawBatch fields) and randomness."""
    ctxt_rgb: torch.Tensor
    ctxt_extrinsics: torch.Tensor
    ctxt_intrinsics: torch.Tensor
    robot_action: torch.Tensor
    trgt_rgb: torch.Tensor
    trgt_depth: torch.Tensor
    trgt_extrinsics: torch.Tensor
    trgt_intrinsics: torch.Tensor
    near: torch.Tensor
    far: torch.Tensor
    draws: Sequence[torch.Tensor]
    yx: Optional[torch.Tensor] = None
    flow: Optional[torch.Tensor] = None
    pixel_selector: Optional[torch.Tensor] = None
    pixel_motion: Optional[torch.Tensor] = None
    pixel_visible_mask: Optional[torch.Tensor] = None


def _rays_and_targets(x: StepInputs):
    b, h, w = x.trgt_rgb.shape[:3]
    rgb = x.trgt_rgb.reshape(b, h * w, 3)
    depth = x.trgt_depth.reshape(b, h * w)
    if x.pixel_selector is not None:
        sel = x.pixel_selector.long()
        yx = torch.stack([sel // w, sel % w], dim=-1)  # [B, N, 2]
        xy = torch.stack([(yx[..., 1].float() + 0.5) / w, (yx[..., 0].float() + 0.5) / h],
                         dim=-1)
        o, d, z = rays_from_coords(xy, x.trgt_intrinsics, x.trgt_extrinsics)
        t_rgb = torch.gather(rgb, 1, sel[..., None].expand(-1, -1, 3))
        t_depth = torch.gather(depth, 1, sel)
        flow = x.pixel_motion
    else:
        yx = x.yx.long()
        o, d, z = pixel_rays(yx, h, w, x.trgt_intrinsics, x.trgt_extrinsics)
        flat = yx[:, 0] * w + yx[:, 1]
        t_rgb, t_depth = rgb[:, flat], depth[:, flat]
        flow = None if x.flow is None else x.flow.reshape(b, h * w, 2)[:, flat]
    r = o.shape[1]
    rays = Rays(o, d, x.near[:, None].expand(b, r), x.far[:, None].expand(b, r))
    return rays, t_rgb, (t_depth / z[..., 0])[..., None], flow


def anneal_at(count: float, rendering: dict) -> float:
    """The proposal weights' anneal exponent at the optimizer's count."""
    if not rendering["use_proposal_weight_anneal"]:
        return 1.0
    c = torch.tensor(count, dtype=torch.float32)
    frac = torch.clamp(c / rendering["proposal_weights_anneal_max_num_iters"], 0.0, 1.0)
    slope = rendering["proposal_weights_anneal_slope"]
    return float((slope * frac) / ((slope - 1.0) * frac + 1.0))


def train_step(field: Field, opt: Adam, x: StepInputs, updated: bool, mode: str,
               loss_cfg: dict) -> float:
    """One step in place on field.p and opt: the forward in training mode,
    the stage's loss, its gradient, Adam. Returns the loss."""
    p, cfg = field.p, field.cfg
    names = opt.names
    leaves = {n: p[n].detach().requires_grad_(n in names) for n in p}
    f = Field(cfg, leaves, field.q)
    updates: Dict[str, torch.Tensor] = {}
    rays, t_rgb, t_depth, t_flow = _rays_and_targets(x)
    knots_args = (rays.origins, rays.directions, rays.near, rays.far, x.ctxt_extrinsics,
                  x.ctxt_intrinsics, tuple(cfg["rendering"]["epipolar_knots"]))
    b, r = rays.near.shape
    s = cfg["rendering"]["num_nerf_samples"]
    h, w = x.trgt_rgb.shape[1:3]
    anneal = anneal_at(opt.count, cfg["rendering"])
    if mode == "perception":
        pyr = encode(leaves, x.ctxt_rgb, cfg["encoder"]["num_layers"], True, field.q, updates)
        knots = ray_knots(tuple(field.q(t) for t in pyr), *knots_args)
        final, levels = f.sample(knots, rays, x.ctxt_extrinsics, x.ctxt_intrinsics, x.draws,
                                 updated, anneal)
        pos = final.positions(rays.origins, rays.directions)
        z, pe = f.point_inputs(knots, pos, x.ctxt_extrinsics, x.ctxt_intrinsics)
        density, feats = f.density_head(z, pe)
        weights = render_weights(density.reshape(b, r, s), final.deltas)
        color = f.color(feats, rays.directions, s).reshape(b, r, s, 3)
        rgb = torch.sum(weights[..., None] * color, dim=-2)
        loss = perception_loss(levels, final, weights, rgb, t_rgb, t_depth, loss_cfg)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)
        loss_value = float(loss.detach())
    else:
        with torch.no_grad():
            pyr = encode(leaves, x.ctxt_rgb, cfg["encoder"]["num_layers"], True, field.q,
                         updates)
            knots = ray_knots(tuple(field.q(t) for t in pyr), *knots_args)
            final, _ = f.sample(knots, rays, x.ctxt_extrinsics, x.ctxt_intrinsics, x.draws,
                                updated, anneal)
            pos = final.positions(rays.origins, rays.directions)
            z, pe = f.point_inputs(knots, pos, x.ctxt_extrinsics, x.ctxt_intrinsics)
            density, _ = f.density_head(z, pe)
            weights = render_weights(density.reshape(b, r, s), final.deltas)
            z, pe = z.reshape(b, r, s, -1), pe.reshape(b, r, s, -1)
        intr_px = to_pixels(x.trgt_intrinsics, h, w)
        mask = x.pixel_visible_mask
        den = (torch.clamp(mask.sum(), min=1.0) if mask is not None
               else torch.tensor(float(b * r * 2), device=z.device))
        grads = [torch.zeros_like(leaves[n]) for n in names]
        loss_value = 0.0
        for r0 in range(0, r, RAY_CHUNK):
            r1 = min(r, r0 + RAY_CHUNK)
            n_pts = (r1 - r0) * s
            jac = f.jacobian(z[:, r0:r1].reshape(b, n_pts, -1), pe[:, r0:r1].reshape(b, n_pts, -1))
            j = jac.reshape(b, r1 - r0, s, -1, 3)
            sf = torch.einsum("brsat,ba->brst", j, x.robot_action)
            flow = composite_flow(weights[:, r0:r1], pos[:, r0:r1], sf, x.trgt_extrinsics,
                                  intr_px)
            err = loss_cfg["flow_weight"] * (flow - t_flow[:, r0:r1]) ** 2
            if mask is not None:
                err = err * mask[:, r0:r1, None]
            part = err.sum() / den
            loss_value += float(part.detach())
            for acc, g in zip(grads, torch.autograd.grad(part, [leaves[n] for n in names],
                                                         allow_unused=True)):
                if g is not None:
                    acc.add_(g)
    grads = {n: (torch.zeros_like(p[n]) if g is None else g.detach())
             for n, g in zip(names, grads)}
    with torch.no_grad():
        opt.step(p, grads)
        for k, v in updates.items():
            p[k].copy_(v)
    return loss_value


def new_optimizer(field: Field, mode: str, lr: float, warm_up_steps: int, count: int) -> Adam:
    names = [n for n in field.p if trainable(n, field.cfg, mode)]
    return Adam(names, field.p, lr, warm_up_steps, count)


# ---------------------------------------------------------------- control step

@torch.no_grad()
def encode_image(field: Field, image, ctx_ext, ctx_intr, rays: Rays):
    """The cached field of the served path: (density, Jacobian [B, R, S,
    3A], weights [B, R, S], positions [B, R, S, 3]) at the deterministic
    samples of the eval-mode model."""
    cfg = field.cfg
    pyr = encode(field.p, image, cfg["encoder"]["num_layers"], False, field.q, {})
    knots = ray_knots(tuple(field.q(t) for t in pyr), rays.origins, rays.directions,
                      rays.near, rays.far, ctx_ext, ctx_intr,
                      tuple(cfg["rendering"]["epipolar_knots"]))
    final, _ = field.sample(knots, rays, ctx_ext, ctx_intr, None, False)
    pos = final.positions(rays.origins, rays.directions)
    b, r, s = pos.shape[:3]
    z, pe = field.point_inputs(knots, pos, ctx_ext, ctx_intr)
    density, _ = field.density_head(z, pe)
    density = density.reshape(b, r, s)
    jac = field.jacobian(z, pe).reshape(b, r, s, -1)
    return density, jac, render_weights(density, final.deltas), pos


def solve(jac, weights, positions, trgt_ext, trgt_intr, target, action0, num_iters=100,
          lr=0.1, b1=0.9, b2=0.999, eps=1e-8):
    """Adam on the action against the target flow over the cached field (the
    best action seen, the final one scored too). Returns (action, loss)."""
    a_dim = action0.shape[-1]
    j = jac.reshape(*jac.shape[:-1], a_dim, -1)

    def loss_fn(a):
        sf = torch.einsum("brsat,ba->brst", j, a)
        return torch.mean((composite_flow(weights, positions, sf[..., :3], trgt_ext, trgt_intr)
                           - target) ** 2)

    action = action0.detach()
    m, v = torch.zeros_like(action), torch.zeros_like(action)
    best, best_loss = action, torch.full((), float("inf"), device=action.device)
    for step in range(1, num_iters + 1):
        a = action.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(a)
            (g,) = torch.autograd.grad(loss, a)
        loss = loss.detach()
        best = torch.where(loss < best_loss, action, best)
        best_loss = torch.minimum(loss, best_loss)
        m = (1 - b1) * g + b1 * m
        v = (1 - b2) * (g * g) + b2 * v
        bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** step)
        bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** step)
        action = action + (m / bc1) / (torch.sqrt(v / bc2) + eps) * -lr
    with torch.no_grad():
        final = loss_fn(action)
    best = torch.where(final < best_loss, action, best)
    return best, torch.minimum(final, best_loss)
