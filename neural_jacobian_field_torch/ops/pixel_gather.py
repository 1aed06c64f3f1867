"""Pixel-aligned feature gathers (PyTorch counterpart of ops/pixel_gather.py).

The JAX package packs the fine and mid pyramid levels so one row fetch
returns a whole 2x2 bilinear patch (`pack_2x2`, kernel K6) and gathers rows
by index (`gather_packed_rows`). On the card a row gather is a plain indexed
read, so `gather_packed_rows` is `torch.gather` plus the four-corner
weighted sum. The coarse level (layer3, 30x40 at a 480x640 image) is sampled
by K1 (`gather_bilinear_onehot`: K1-fwd forward, K1-bwd backward).
`pyramid_pixel_features` samples all three levels at every point: the exact
(reference-numerics) feature path.
Sample coordinates are not differentiable leaves in this model; nothing here
takes their gradient (the features are: the packing's gradient is K6-bwd,
the row gather's a scatter-add, as the JAX custom_vjp scatter-adds, in a
fixed order (`ops/deterministic.gather_rows`: the generalised K1-bwd
scatter), the coarse level's is K1-bwd).
"""

from dataclasses import dataclass
from typing import Tuple

import torch

from ..utils import profiling
from .deterministic import gather_rows


def bilinear_corners(x: torch.Tensor, y: torch.Tensor, width: int, height: int):
    """Continuous (x, y) in pixel units -> clamped corner base (int64) and
    weights. x0 = clamp(floor(clamp(x, 0, W-1)), 0, W-2) keeps the 2x2 patch
    in bounds and reproduces border-clamped bilinear exactly. NaN coordinates
    (0/0 z-divides) are zeroed first so the index stays defined."""
    x = torch.nan_to_num(x, nan=0.0)
    y = torch.nan_to_num(y, nan=0.0)
    x = torch.clamp(x, 0.0, width - 1)
    y = torch.clamp(y, 0.0, height - 1)
    x0 = torch.clamp(torch.floor(x), 0, max(width - 2, 0))
    y0 = torch.clamp(torch.floor(y), 0, max(height - 2, 0))
    return x0.long(), y0.long(), x - x0, y - y0


def _corner_weights(wx: torch.Tensor, wy: torch.Tensor) -> torch.Tensor:
    """[..., 4] weights in corner order (y0x0, y0x1, y1x0, y1x1)."""
    return torch.stack([(1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx), wy * wx],
                       dim=-1)


def pack_2x2(level: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H, W, 4C]: row (y, x) holds the 2x2 patch
    [F[y,x], F[y,x+1], F[y+1,x], F[y+1,x+1]], last row/column replicated."""
    right = torch.cat([level[:, :, 1:], level[:, :, -1:]], dim=2)
    down = torch.cat([level[:, 1:], level[:, -1:]], dim=1)
    down_right = torch.cat([down[:, :, 1:], down[:, :, -1:]], dim=2)
    return torch.cat([level, right, down, down_right], dim=-1)


def gather_packed_rows(packed: torch.Tensor, idx: torch.Tensor,
                       w4: torch.Tensor) -> torch.Tensor:
    """packed [B, HW, 4C], idx [B, N] flat row ids, w4 [B, N, 4] corner
    weights -> [B, N, C] bilinear samples, computed in packed's dtype (the
    corner sum in the same order as the JAX package)."""
    c = packed.shape[-1] // 4
    rows = gather_rows(packed, idx)
    w4 = w4.to(packed.dtype)
    out = rows[..., 0:c] * w4[..., 0:1]
    for cnr in range(1, 4):
        out = out + rows[..., cnr * c:(cnr + 1) * c] * w4[..., cnr:cnr + 1]
    return out


@dataclass
class FeaturePyramid:
    """Encoder output in pyramid layout: fine = conv1 ++ up2(layer1) at conv1
    resolution; mid = layer2 and coarse = layer3 at native resolution. NHWC."""

    fine: torch.Tensor  # [B, Hf, Wf, 128]
    mid: torch.Tensor  # [B, Hf/4, Wf/4, 128]
    coarse: torch.Tensor  # [B, Hf/8, Wf/8, 256]

    def to(self, dtype):
        return FeaturePyramid(self.fine.to(dtype), self.mid.to(dtype),
                              self.coarse.to(dtype))


@dataclass
class PackedPyramid:
    """Gather-ready pyramid: fine2/mid2 packed by pack_2x2 and flattened,
    coarse raw."""

    fine2: torch.Tensor  # [B, Hf*Wf, 4*Cf]
    mid2: torch.Tensor  # [B, Hm*Wm, 4*Cm]
    coarse: torch.Tensor  # [B, Hc, Wc, Cc]
    fine_hw: Tuple[int, int]
    mid_hw: Tuple[int, int]


def feature_fields(features) -> tuple:
    """Context features as a flat tuple (the encoder program's outputs,
    inference/programs.py): a PackedPyramid's fields in order, or the one
    map of the concat layout."""
    if isinstance(features, PackedPyramid):
        return features.fine2, features.mid2, features.coarse, features.fine_hw, features.mid_hw
    return (features,)


def features_from_fields(fields: tuple):
    """The inverse of feature_fields."""
    return PackedPyramid(*fields) if len(fields) > 1 else fields[0]


def pack_pyramid(pyr: FeaturePyramid) -> PackedPyramid:
    """Pack the fine and mid levels through K6 (once per encoded image)."""
    from .kernels.pack2x2 import pack_2x2_flat_train

    _, hf, wf, _ = pyr.fine.shape
    _, hm, wm, _ = pyr.mid.shape
    return PackedPyramid(fine2=pack_2x2_flat_train(pyr.fine),
                         mid2=pack_2x2_flat_train(pyr.mid),
                         coarse=pyr.coarse, fine_hw=(hf, wf), mid_hw=(hm, wm))


def _level_coords(fx, fy, stride):
    """Fine-grid pixel coords -> coarser-level pixel coords:
    c = (f + 0.5) / s - 0.5."""
    return (fx + 0.5) / stride - 0.5, (fy + 0.5) / stride - 0.5


def _corner_ids(cx, cy, width: int, height: int):
    """Pixel coords [B, N] -> flat corner ids [B, N, 4] (int64) and corner
    weights [B, N, 4], corners in order (y0x0, y0x1, y1x0, y1x1)."""
    x0, y0, wx, wy = bilinear_corners(cx, cy, width, height)
    base = y0 * width + x0
    idx = torch.stack([base, base + 1, base + width, base + width + 1], dim=-1)
    return idx, _corner_weights(wx, wy)


class _GatherBilinearOnehot(torch.autograd.Function):
    """K1-fwd forward, K1-bwd backward (the JAX custom_vjp of
    gather_bilinear_onehot): the map's gradient is the scatter of the
    upstream gradient cast to the map's dtype, returned in that dtype; the
    corner ids and weights get none."""

    @staticmethod
    def forward(ctx, level, idx, w4):
        from .kernels import onehot_gather as k1

        b, hc, wc, c = level.shape
        ctx.save_for_backward(idx, w4)
        ctx.shape, ctx.dtype = level.shape, level.dtype
        return k1.onehot_gather_fwd(level.reshape(b, hc * wc, c), idx, w4)

    @staticmethod
    def backward(ctx, g):
        from .kernels import onehot_gather as k1

        idx, w4 = ctx.saved_tensors
        b, hc, wc, c = ctx.shape
        gf = k1.onehot_scatter_bwd(g.to(ctx.dtype), idx, w4, hc * wc)
        return gf.reshape(b, hc, wc, c).to(ctx.dtype), None, None


def gather_bilinear_onehot(level: torch.Tensor, cx: torch.Tensor,
                           cy: torch.Tensor) -> torch.Tensor:
    """Bilinear-sample `level` [B, Hc, Wc, C] at pixel coords (cx, cy) [B, N]
    (border-clamped, align_corners=True). Returns [B, N, C] float32."""
    _, hc, wc, _ = level.shape
    idx, w4 = _corner_ids(cx, cy, wc, hc)
    return _GatherBilinearOnehot.apply(level, idx, w4)


def pyramid_pixel_levels(pyr: PackedPyramid, fx: torch.Tensor, fy: torch.Tensor):
    """Sample each pyramid level at fine-grid pixel coords (fx, fy) [B, N]:
    (fine [B, N, Cf], mid [B, N, Cm] in the packed maps' dtype, coarse
    [B, N, Cc] float32). The fused trunk takes them level by level. Counted
    as the running program's `pixel_gathers` (utils/profiling.py): points x
    levels."""
    profiling.pixel_gathers(3 * fx.numel())
    hf, wf = pyr.fine_hw
    hm, wm = pyr.mid_hw
    hc = pyr.coarse.shape[1]

    x0, y0, wx, wy = bilinear_corners(fx, fy, wf, hf)
    fine = gather_packed_rows(pyr.fine2, y0 * wf + x0, _corner_weights(wx, wy))

    sm = (hf + hm - 1) // hm  # fine->mid stride (4 at the reference shapes)
    mx, my = _level_coords(fx, fy, sm)
    x0, y0, wx, wy = bilinear_corners(mx, my, wm, hm)
    mid = gather_packed_rows(pyr.mid2, y0 * wm + x0, _corner_weights(wx, wy))

    sc = (hf + hc - 1) // hc
    cx, cy = _level_coords(fx, fy, sc)
    return fine, mid, gather_bilinear_onehot(pyr.coarse, cx, cy)


def pyramid_pixel_features(pyr: PackedPyramid, fx: torch.Tensor,
                           fy: torch.Tensor) -> torch.Tensor:
    """All pyramid levels at (fx, fy) [B, N], channels concatenated in
    reference order: [B, N, C_total] float32 (as the JAX package's concat
    promotes it)."""
    return torch.cat([t.float() for t in pyramid_pixel_levels(pyr, fx, fy)], dim=-1)
