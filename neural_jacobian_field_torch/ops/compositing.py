"""Volume-rendering compositing reductions (PyTorch counterpart of
ops/compositing.py): the alpha-compositing weights, the weighted sum of
values along the sample axis and the clipped expected depth. The model
composites rgb, depth and flow inline, as the JAX model does."""

import torch


def render_weights(densities: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """weights_i = (1 - exp(-sigma_i delta_i)) * exp(-sum_{j<i} sigma_j delta_j);
    zero-width bins (delta <= 0) contribute nothing. [..., S, 1] -> [..., S, 1]."""
    delta_density = torch.where(deltas > 0, deltas * densities,
                                torch.zeros_like(densities))
    alphas = 1.0 - torch.exp(-delta_density)
    accum = torch.cumsum(delta_density[..., :-1, :], dim=-2)
    accum = torch.cat([torch.zeros_like(accum[..., :1, :]), accum], dim=-2)
    return alphas * torch.exp(-accum)


def composite(weights: torch.Tensor, values: torch.Tensor, bg_value=None) -> torch.Tensor:
    """sum_i w_i v_i along the sample axis: weights [..., S, 1], values
    [..., S, C] -> [..., C]; with `bg_value`, plus (1 - sum_i w_i) * bg_value."""
    out = torch.sum(weights * values, dim=-2)
    if bg_value is not None:
        out = out + (1.0 - torch.sum(weights, dim=-2)) * bg_value
    return out


def render_depth(weights: torch.Tensor, steps: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Expected depth sum_i w_i t_i / (sum_i w_i + eps), clipped to the range
    of `steps` [..., S, 1] (the bin centres). Returns [..., 1]."""
    depth = torch.sum(weights * steps, dim=-2) / (torch.sum(weights, dim=-2) + eps)
    return torch.clamp(depth, steps.min(), steps.max())
