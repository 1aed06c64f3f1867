"""Training losses, assembled as the reference's ModelWrapper does
(PyTorch counterpart of training/losses.py). Perception stage: rgb MSE
+ 0.08 * DS-NeRF depth (averaged over all levels, sigma 0.001) + 1.0 *
interlevel + 0.01 * distortion. Action stage: 0.01 * flow MSE, masked by
the tracks' visibility when there is a mask.

Inside a data-parallel step (an active mesh, parallel/mesh.py) each rank
holds its rows of the global batch. The masked mean divides the global sum
by the global count (a mean of the ranks' means is not that where the ranks
see different numbers of visible tracks); a plain mean stays the rank's,
whose mean over the ranks is the global one (equal shards), and the
gradients' mean over the ranks makes either the global loss's gradient. The
metrics are the global batch's on every rank: means averaged over the
ranks, the percentiles and the valid depths' mean of the gathered
depths."""

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..models.model import ModelOutput, ModelTarget
from ..ops.losses import distortion_loss, ds_nerf_depth_loss, interlevel_loss
from ..parallel.mesh import active_mesh, all_gather, all_reduce, all_reduce_sum


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

    means = {
        "loss/rgb": rgb_loss,
        "loss/depth": depth_loss,
        "loss/interlevel": inter,
        "loss/distortion": dist,
        "loss/total": total,
        "depth/pred_mean": torch.mean(out.depth),
    }
    mesh = active_mesh()
    trgt_depth, pred_depth = target.depth, out.depth
    if mesh is not None:
        keys = list(means)
        avg = all_reduce(torch.stack([torch.as_tensor(means[k]).detach().float()
                                      for k in keys]), mesh) / mesh.size
        means = dict(zip(keys, avg.unbind()))
        trgt_depth, pred_depth = all_gather(trgt_depth, mesh), all_gather(pred_depth, mesh)
    valid = torch.where(trgt_depth > 0, trgt_depth, torch.full_like(trgt_depth, float("nan")))
    metrics = {
        **means,
        "depth/trgt_10_percentile": torch.nanquantile(valid, 0.1),
        "depth/trgt_90_percentile": torch.nanquantile(valid, 0.9),
        "depth/trgt_mean": torch.nanmean(valid),
        "depth/pred_10_percentile": torch.quantile(pred_depth, 0.1),
        "depth/pred_90_percentile": torch.quantile(pred_depth, 0.9),
    }
    return total, {k: torch.as_tensor(v).detach() for k, v in metrics.items()}


def action_loss(out: ModelOutput, target: ModelTarget,
                cfg: LossCfg = LossCfg()) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, metrics): flow_weight * the squared flow error, averaged
    over every component, or with a visibility mask summed over the visible
    rays' components and divided by the number of visible rays (at least 1)."""
    err = cfg.flow_weight * (out.optical_flow - target.optical_flow) ** 2
    mesh = active_mesh()
    if target.visible_mask is not None:
        mask = target.visible_mask.to(err.dtype)
        num, den = torch.sum(err * mask[..., None]), torch.sum(mask)
        if mesh is not None:  # the global sum over the global count
            num, den = all_reduce_sum(torch.stack([num, den]), mesh)
        flow_loss = num / torch.clamp(den, min=1.0)
    else:
        flow_loss = torch.mean(err)
    logged = flow_loss.detach()
    if mesh is not None and target.visible_mask is None:  # the ranks' means averaged
        logged = all_reduce(logged, mesh) / mesh.size
    return flow_loss, {"loss/flow": logged, "loss/total": logged}
