"""Bilinear feature lookup (PyTorch counterpart of ops/grid_sample.py): the
concat feature layout's pixel-aligned sampling, and the zeros mode a RAFT
correlation lookup reads.

The JAX formula as plain tensor ops, in its order: scale to pixel units,
clamp (border mode), floor, four gathers of the flattened map, lerp. So the
values and the gradients match JAX's (the floor's zero gradient, the
clamp's zero gradient outside and half gradient on the border included),
which F.grid_sample's do not. The four corners are one row gather
(`ops/deterministic.gather_rows`), so the feature map's gradient is summed
per texel in a fixed order (torch.gather's own backward, scatter_add_, sums
with atomics on CUDA and differs from run to run, as F.grid_sample's
backward would).
"""

import torch

from .deterministic import gather_rows


def grid_sample_bilinear(features: torch.Tensor, coords: torch.Tensor,
                         padding_mode: str = "border") -> torch.Tensor:
    """Sample `features` [B, H, W, C] (NHWC) at xy coords [B, N, 2] in [-1, 1]
    (align_corners=True: -1 is pixel centre 0, +1 is W-1 / H-1). "border"
    clamps out-of-range coords; "zeros" reads 0 for each corner texel out of
    bounds (torch grid_sample's default). An empty map (H or W 0, RAFT's
    coarsest correlation level below 64 px a side) reads zeros, as JAX's
    gather does. Returns [B, N, C]."""
    if padding_mode not in ("border", "zeros"):
        raise ValueError(f"unknown padding_mode {padding_mode!r}")
    b, h, w, c = features.shape
    if h == 0 or w == 0:
        return features.new_zeros((b, coords.shape[1], c))
    x = (coords[..., 0] + 1.0) * 0.5 * (w - 1)
    y = (coords[..., 1] + 1.0) * 0.5 * (h - 1)
    if padding_mode == "border":
        # jnp.clip's maximum then minimum: at a tie the gradient is halved,
        # as JAX's (torch.clamp would pass it whole); the bounds are filled
        # on the device (no host copy, so a captured program can run it)
        x = torch.minimum(torch.maximum(x, torch.zeros_like(x)), torch.full_like(x, w - 1.0))
        y = torch.minimum(torch.maximum(y, torch.zeros_like(y)), torch.full_like(y, h - 1.0))
    x0, y0 = torch.floor(x), torch.floor(y)
    x1, y1 = x0 + 1, y0 + 1
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    flat = features.reshape(b, h * w, c)

    def index(v, n):
        # a NaN coordinate reads texel 0, as XLA converts NaN to 0
        return torch.nan_to_num(torch.clamp(v, 0, n - 1), nan=0.0).long()

    corners = ((y0, x0), (y0, x1), (y1, x0), (y1, x1))
    n = coords.shape[1]
    rows = gather_rows(flat, torch.cat([index(yi, h) * w + index(xi, w) for yi, xi in corners],
                                       dim=1))

    def take(i):
        out = rows[:, i * n:(i + 1) * n]
        if padding_mode == "zeros":
            yi, xi = corners[i]
            valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            out = out * valid[..., None].to(out.dtype)
        return out

    f00, f01, f10, f11 = take(0), take(1), take(2), take(3)
    top = f00 * (1.0 - wx) + f01 * wx
    bot = f10 * (1.0 - wx) + f11 * wx
    return top * (1.0 - wy) + bot * wy
