"""Training losses, assembled as the reference's ModelWrapper does
(PyTorch counterpart of training/losses.py). Perception stage: rgb MSE
+ 0.08 * DS-NeRF depth (averaged over all levels, sigma 0.001) + 1.0 *
interlevel + 0.01 * distortion."""

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..models.model import ModelOutput, ModelTarget
from ..ops.losses import distortion_loss, ds_nerf_depth_loss, interlevel_loss


@dataclass(frozen=True)
class LossCfg:
    depth_sigma: float = 0.001
    depth_weight: float = 0.08
    interlevel_weight: float = 1.0
    distortion_weight: float = 0.01
    flow_weight: float = 0.01


def perception_loss(out: ModelOutput, target: ModelTarget,
                    cfg: LossCfg = LossCfg()) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, metrics). The metrics are detached scalars: the loss
    terms and the depth distribution (valid target depths are > 0)."""
    rgb_loss = torch.mean((out.rgb - target.rgb) ** 2)
    depth_loss = 0.0
    n_levels = len(out.weights_list)
    for weights, tdist in zip(out.weights_list, out.tdist_list):
        steps = ((tdist[..., :-1] + tdist[..., 1:]) / 2)[..., None]
        lengths = (tdist[..., 1:] - tdist[..., :-1])[..., None]
        depth_loss = depth_loss + ds_nerf_depth_loss(
            weights, target.depth, steps, lengths, cfg.depth_sigma) / n_levels
    depth_loss = cfg.depth_weight * depth_loss
    inter = cfg.interlevel_weight * interlevel_loss(out.sdist_list, out.weights_list)
    dist = cfg.distortion_weight * distortion_loss(out.sdist_list, out.weights_list)
    total = rgb_loss + depth_loss + inter + dist

    valid = torch.where(target.depth > 0, target.depth,
                        torch.full_like(target.depth, float("nan")))
    metrics = {
        "loss/rgb": rgb_loss,
        "loss/depth": depth_loss,
        "loss/interlevel": inter,
        "loss/distortion": dist,
        "loss/total": total,
        "depth/trgt_10_percentile": torch.nanquantile(valid, 0.1),
        "depth/trgt_90_percentile": torch.nanquantile(valid, 0.9),
        "depth/trgt_mean": torch.nanmean(valid),
        "depth/pred_10_percentile": torch.quantile(out.depth, 0.1),
        "depth/pred_90_percentile": torch.quantile(out.depth, 0.9),
        "depth/pred_mean": torch.mean(out.depth),
    }
    return total, {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
