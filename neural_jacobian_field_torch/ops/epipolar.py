"""Epipolar ray-knot features (PyTorch counterpart of ops/epipolar.py).

All samples of a ray project onto one 2D segment in the context image. Per
ray, M knot features are gathered along the clipped segment at each pyramid
level (`build_ray_knots`); per sample, the two neighbouring knots are
linearly interpolated at the sample's position s on the segment. The
interpolation is kept lazy (`KnotFeatures`) so the trunks can project the
knots before interpolating (`project_then_interp`).

Only the default contraction form of the JAX package (NJF_KW_DOT=2d, one
(B*R)-batched matmul) is ported; the 4-D variant is the same product.
"""

from dataclasses import dataclass
from typing import Tuple

import torch

from ..rendering.geometry import homogenize_points, project_z_divide, transform_world2cam
from .pixel_gather import (
    PackedPyramid,
    _corner_weights,
    _level_coords,
    bilinear_corners,
    gather_packed_rows,
)


@dataclass
class RayKnots:
    """Per-ray knot textures + the segment parameterisation in fine px."""

    fine: torch.Tensor  # [B, R, Mf, Cf]
    mid: torch.Tensor  # [B, R, Mm, Cm]
    coarse: torch.Tensor  # [B, R, Mc, Cc]
    p0: torch.Tensor  # [B, R, 2]
    pdir: torch.Tensor  # [B, R, 2]
    inv_len2: torch.Tensor  # [B, R, 1]
    fine_hw: Tuple[int, int]


def _clip_segment(p0: torch.Tensor, p1: torch.Tensor, width: float, height: float):
    """Liang-Barsky clip of 2D segments to the padded image box [-1, W] x
    [-1, H]. Degenerate or fully-outside segments keep (p0, p1)."""
    d = p1 - p0
    lo = torch.tensor([-1.0, -1.0], dtype=p0.dtype, device=p0.device)
    hi = torch.tensor([width + 0.0, height + 0.0], dtype=p0.dtype, device=p0.device)
    parallel = torch.abs(d) < 1e-9
    safe_d = torch.where(parallel, torch.full_like(d, 1e-9), d)
    ta = (lo - p0) / safe_d
    tb = (hi - p0) / safe_d
    tmin = torch.minimum(ta, tb)
    tmax = torch.maximum(ta, tb)
    outside = (p0 < lo) | (p0 > hi)
    inf = torch.full_like(d, float("inf"))
    tmin = torch.where(parallel, torch.where(outside, inf, -inf), tmin)
    tmax = torch.where(parallel, torch.where(outside, -inf, inf), tmax)
    t0 = torch.clamp(tmin.amax(dim=-1), 0.0, 1.0)
    t1 = torch.clamp(tmax.amin(dim=-1), 0.0, 1.0)
    valid = t1 > t0
    t0 = torch.where(valid, t0, torch.zeros_like(t0))[..., None]
    t1 = torch.where(valid, t1, torch.ones_like(t1))[..., None]
    return p0 + t0 * d, p0 + t1 * d


def _gather_level_knots(packed, hw, stride, p0, pdir, m):
    """m bilinear knots per ray from one packed level -> [B, R, m, C]."""
    h, w = hw
    b, r = p0.shape[:2]
    frac = torch.linspace(0.0, 1.0, m, dtype=p0.dtype, device=p0.device)
    pk = p0[:, :, None, :] + frac[None, None, :, None] * pdir[:, :, None, :]
    lx, ly = _level_coords(pk[..., 0], pk[..., 1], stride)
    x0, y0, wx, wy = bilinear_corners(lx.reshape(b, r * m), ly.reshape(b, r * m), w, h)
    knots = gather_packed_rows(packed, y0 * w + x0, _corner_weights(wx, wy))
    return knots.reshape(b, r, m, knots.shape[-1])


def build_ray_knots(pyr: PackedPyramid, origins: torch.Tensor, directions: torch.Tensor,
                    z_near: torch.Tensor, z_far: torch.Tensor, cam2world: torch.Tensor,
                    intrinsics: torch.Tensor,
                    num_knots: Tuple[int, int, int] = (64, 16, 8)) -> RayKnots:
    """Project each ray's [z_near, z_far] span into the context camera, clip,
    and gather per-level knot textures. origins/directions [B, R, 3]; z_near/
    z_far [B, R]; intrinsics normalized. The coarse level is packed here
    through K6."""
    from .kernels.pack2x2 import pack_2x2_flat_train

    hf, wf = pyr.fine_hw
    hm, wm = pyr.mid_hw
    hc, wc = pyr.coarse.shape[1:3]
    ends = torch.stack([origins + z_near[..., None] * directions,
                        origins + z_far[..., None] * directions], dim=2)  # [B,R,2,3]
    cam = transform_world2cam(homogenize_points(ends), cam2world[:, None, None])[..., :3]
    cam = torch.cat([cam[..., :2], torch.clamp(cam[..., 2:], min=1e-6)], dim=-1)
    uvw, _ = project_z_divide(cam, intrinsics[:, None, None])
    px = torch.stack([uvw[..., 0] * (wf - 1), uvw[..., 1] * (hf - 1)], dim=-1)
    p0, p1 = _clip_segment(px[:, :, 0], px[:, :, 1], float(wf - 1), float(hf - 1))
    pdir = p1 - p0
    inv_len2 = 1.0 / torch.clamp(torch.sum(pdir * pdir, dim=-1, keepdim=True), min=1e-8)

    sm = (hf + hm - 1) // hm
    sc = (hf + hc - 1) // hc
    coarse2 = pack_2x2_flat_train(pyr.coarse)
    mf, mm, mc = num_knots
    return RayKnots(
        fine=_gather_level_knots(pyr.fine2, (hf, wf), 1, p0, pdir, mf),
        mid=_gather_level_knots(pyr.mid2, (hm, wm), sm, p0, pdir, mm),
        coarse=_gather_level_knots(coarse2, (hc, wc), sc, p0, pdir, mc),
        p0=p0, pdir=pdir, inv_len2=inv_len2, fine_hw=(hf, wf))


def _hat_matrix(s: torch.Tensor, m: int, dtype) -> torch.Tensor:
    """2-sparse linear-interp weights over m knots: [B, R, S, m] with (1-w) at
    floor(s*(m-1)) and w at the next knot."""
    pos = s * (m - 1)
    k0 = torch.clamp(torch.floor(pos), 0, m - 2)
    w = (pos - k0).to(dtype)
    k0 = k0.long()[..., None]
    cols = torch.arange(m, device=s.device).view(1, 1, 1, m)
    zero = torch.zeros((), dtype=dtype, device=s.device)
    onehot = torch.where(cols == k0, (1.0 - w)[..., None], zero).to(dtype)
    return onehot + torch.where(cols == k0 + 1, w[..., None], zero).to(dtype)


def _bmm_f32_acc(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    """Batched matmul accumulated in at least float32, cast to out_dtype."""
    at = torch.float64 if a.dtype == torch.float64 else torch.float32
    if a.device.type == "cuda" and a.dtype == torch.bfloat16:
        # cuBLAS accumulates bf16 products in float32
        return torch.bmm(a, b).to(out_dtype)
    return torch.bmm(a.to(at), b.to(at)).to(out_dtype)


def _interp_knots(level: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """level [B, R, M, C], s [B, R, S] in [0, 1] -> [B, R, S, C] in level's
    dtype (accumulated in float32)."""
    b, r, m, c = level.shape
    sn = s.shape[2]
    onehot = _hat_matrix(s, m, level.dtype)
    out = _bmm_f32_acc(onehot.reshape(b * r, sn, m), level.reshape(b * r, m, c),
                       level.dtype)
    return out.reshape(b, r, sn, c)


@dataclass
class KnotFeatures:
    """Lazy pixel-aligned features: per-ray knots plus each sample's segment
    position s, not yet interpolated."""

    levels: Tuple[torch.Tensor, ...]  # ([B,R,Mf,Cf], [B,R,Mm,Cm], [B,R,Mc,Cc])
    s: torch.Tensor  # [B, R, S]

    def interp_levels(self) -> Tuple[torch.Tensor, ...]:
        b, r, sn = self.s.shape
        return tuple(_interp_knots(level, self.s).reshape(b, r * sn, -1)
                     for level in self.levels)

    def concat(self) -> torch.Tensor:
        return torch.cat(self.interp_levels(), dim=-1)

    def project_then_interp(self, w_rows, bias=None) -> torch.Tensor:
        """tz = sum_l H_l @ (K_l @ W_l) (+ bias) for row blocks W_l [C_l, d] of
        the latent projection: the knot-side form of concat() @ W. The level
        projections are stacked along the knot axis and contracted in one
        batched matmul. Returns [B, N, d] in the levels' dtype."""
        b, r, sn = self.s.shape
        kws, hats = [], []
        for level, w in zip(self.levels, w_rows):
            lb, lr, m, c = level.shape
            kw_l = level.reshape(lb * lr * m, c) @ w.to(level.dtype)
            kws.append(kw_l.reshape(lb, lr, m, -1))
            hats.append(_hat_matrix(self.s, m, level.dtype))
        kw = torch.cat(kws, dim=2)  # [B, R, M_total, d]
        hat = torch.cat(hats, dim=-1)  # [B, R, S, M_total]
        m, d = kw.shape[2], kw.shape[3]
        out = _bmm_f32_acc(hat.reshape(b * r, sn, m), kw.reshape(b * r, m, d),
                           kw.dtype).reshape(b, r * sn, d)
        if bias is not None:
            out = out + bias.to(out.dtype)
        return out


def knot_features(knots: RayKnots, fx: torch.Tensor, fy: torch.Tensor) -> KnotFeatures:
    """Bind the knots to the samples' segment positions. fx/fy [B, N] fine-px
    projections; N must be R*S."""
    b, n = fx.shape
    r = knots.p0.shape[1]
    if n % r:
        raise ValueError(f"sample count {n} not a multiple of ray count {r}")
    p = torch.stack([fx, fy], dim=-1).reshape(b, r, n // r, 2)
    rel = p - knots.p0[:, :, None, :]
    s = torch.sum(rel * knots.pdir[:, :, None, :], dim=-1) * knots.inv_len2[:, :, None, 0]
    return KnotFeatures(levels=(knots.fine, knots.mid, knots.coarse),
                        s=torch.clamp(s, 0.0, 1.0).detach())
