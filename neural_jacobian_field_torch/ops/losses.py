"""Rendering losses (PyTorch counterpart of ops/losses.py): nerfstudio's
interlevel and distortion losses and the DS-NeRF depth loss, over
normalized spacing bins (sdist in [0, 1]) and per-sample weights.

The functions are ported, not the TPU workarounds: the interlevel outer
measure uses torch.searchsorted and a row gather where the JAX package uses
a one-hot compare-reduce; distortion is the O(S) cumsum form, as there. The
gather's backward sums in a fixed order (`ops/deterministic.gather_rows`:
each ray an image of S + 1 one-wide rows, which K1-bwd-small sorts and sums
in one thread block), so that a step repeats bit for bit, as the one-hot
reduce does.
"""

import torch

from .deterministic import gather_rows


def outer_measure(t0: torch.Tensor, t1: torch.Tensor, y1: torch.Tensor) -> torch.Tensor:
    """Sum of `y1` mass (over bins t1) covered by each bin of t0.
    t0 [..., S0+1] query edges; t1 [..., S1+1] source edges; y1 [..., S1]
    source mass. Returns [..., S0]."""
    cy1 = torch.cat([torch.zeros_like(y1[..., :1]), torch.cumsum(y1, dim=-1)], dim=-1)
    last = y1.shape[-1] - 1
    idx_lo = torch.searchsorted(t1[..., :-1].contiguous(), t0[..., :-1].contiguous(),
                                right=True) - 1
    idx_lo = torch.clamp(idx_lo, 0, last)
    idx_hi = torch.searchsorted(t1[..., 1:].contiguous(), t0[..., 1:].contiguous(),
                                right=True)
    idx_hi = torch.clamp(idx_hi, 0, last)
    # both gathers as one: cy1[lo] and cy1[hi + 1], per ray
    lead, s0 = idx_lo.shape[:-1], idx_lo.shape[-1]
    rays = cy1.reshape(-1, cy1.shape[-1], 1)
    idx = torch.cat([idx_lo, idx_hi + 1], dim=-1).reshape(rays.shape[0], 2 * s0)
    got = gather_rows(rays, idx)[..., 0].reshape(*lead, 2 * s0)
    return got[..., s0:] - got[..., :s0]


def lossfun_outer(t, w, t_env, w_env, eps: float = 1.1920929e-07):
    """Proposal (interlevel) loss: penalize final weights above the proposal
    envelope (mip-NeRF 360 eq. 13)."""
    w_outer = outer_measure(t, t_env, w_env)
    return torch.clamp(w - w_outer, min=0.0) ** 2 / (w + eps)


def interlevel_loss(sdist_list, weights_list) -> torch.Tensor:
    """Mean proposal loss over the proposal levels against the (detached)
    final level. sdist_list[i] [..., S_i+1]; weights_list[i] [..., S_i, 1]."""
    c = sdist_list[-1].detach()
    w = weights_list[-1][..., 0].detach()
    loss = 0.0
    for sdist, weights in zip(sdist_list[:-1], weights_list[:-1]):
        loss = loss + torch.mean(lossfun_outer(c, w, sdist, weights[..., 0]))
    return loss


def lossfun_distortion(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """mip-NeRF 360 distortion, O(S) form: t [..., S+1] edges, w [..., S]
    weights -> [...]. sum_ij w_i w_j |m_i - m_j| = 2 sum_i w_i (m_i
    cum_{j<i} w_j - cum_{j<i} w_j m_j), plus (1/3) sum_i w_i^2 (t_{i+1} - t_i)."""
    m = (t[..., 1:] + t[..., :-1]) / 2.0
    cw = torch.cumsum(w, dim=-1)
    cwm = torch.cumsum(w * m, dim=-1)
    loss_inter = 2.0 * torch.sum(w * (m * (cw - w) - (cwm - w * m)), dim=-1)
    loss_intra = torch.sum(w ** 2 * (t[..., 1:] - t[..., :-1]), dim=-1) / 3.0
    return loss_inter + loss_intra


def distortion_loss(sdist_list, weights_list) -> torch.Tensor:
    """Mean distortion of the final sampling level."""
    return torch.mean(lossfun_distortion(sdist_list[-1], weights_list[-1][..., 0]))


def ds_nerf_depth_loss(weights: torch.Tensor, termination_depth: torch.Tensor,
                       steps: torch.Tensor, lengths: torch.Tensor, sigma: float,
                       eps: float = 1.0e-7) -> torch.Tensor:
    """Depth-supervised NeRF loss. weights/steps/lengths [..., S, 1];
    termination_depth [..., 1]; rays with depth <= 0 are masked out."""
    depth_mask = termination_depth > 0
    loss = (-torch.log(weights + eps)
            * torch.exp(-((steps - termination_depth[..., None, :]) ** 2) / (2 * sigma))
            * lengths)
    return torch.mean(torch.sum(loss, dim=-2) * depth_mask)
