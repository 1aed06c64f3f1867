"""Ray samplers: spaced sampling + proposal/PDF resampling (PyTorch
counterpart of rendering/samplers.py).

Randomness comes from an optional torch.Generator, or from explicit draws
passed in (so a test can hand in the JAX package's draws); at inference
(stratified=False) every query is deterministic. PDF resampling goes through
the K5 wrapper (ops/kernels/pdf_resample.py) when `use_pallas_pdf` is set
(the config keeps the JAX field name), else through the plain oracle.
"""

from dataclasses import dataclass
from typing import Callable, Sequence, Tuple

import torch

from ..ops.compositing import render_weights
from ..ops.pdf import pdf_queries, sample_pdf


def spacing_fn(kind: str, x: torch.Tensor) -> torch.Tensor:
    """Euclidean distance -> normalized spacing domain."""
    if kind == "uniform":
        return x
    if kind == "lin_disp":
        return 1.0 / x
    if kind == "piecewise":
        return torch.where(x < 1, x / 2, 1 - 1 / (2 * x))
    raise ValueError(kind)


def spacing_fn_inv(kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind == "uniform":
        return x
    if kind == "lin_disp":
        return 1.0 / x
    if kind == "piecewise":
        return torch.where(x < 0.5, 2 * x, 1 / (2 - 2 * x))
    raise ValueError(kind)


@dataclass
class RayBundle:
    """Origins/directions [B, R, 3]; nears/fars [B, R, 1]."""

    origins: torch.Tensor
    directions: torch.Tensor
    nears: torch.Tensor
    fars: torch.Tensor


@dataclass
class RaySamples:
    """Per-sample frusta: starts/ends/deltas [B, R, S, 1] euclidean,
    spacing_starts/ends [B, R, S, 1] in [0, 1], s_near/s_far [B, R, 1]."""

    origins: torch.Tensor  # [B, R, 1, 3]
    directions: torch.Tensor  # [B, R, 1, 3]
    starts: torch.Tensor
    ends: torch.Tensor
    deltas: torch.Tensor
    spacing_starts: torch.Tensor
    spacing_ends: torch.Tensor
    s_near: torch.Tensor
    s_far: torch.Tensor
    spacing: str = "uniform"

    def get_positions(self) -> torch.Tensor:
        """Frustum-centre world positions [B, R, S, 3]."""
        return self.origins + self.directions * (self.starts + self.ends) / 2

    def get_weights(self, densities: torch.Tensor) -> torch.Tensor:
        return render_weights(densities, self.deltas)


def sdist_edges(ray_samples: RaySamples) -> torch.Tensor:
    """Spacing-domain bin edges [B, R, S+1]."""
    return torch.cat([ray_samples.spacing_starts[..., 0],
                      ray_samples.spacing_ends[..., -1:, 0]], dim=-1)


def tdist_edges(ray_samples: RaySamples) -> torch.Tensor:
    """Euclidean bin edges [B, R, S+1] (starts ++ last end), for the DS depth
    loss."""
    return torch.cat([ray_samples.starts[..., 0], ray_samples.ends[..., -1:, 0]], dim=-1)


def _from_spacing_bins(ray_bundle: RayBundle, bins: torch.Tensor, kind: str,
                       s_near: torch.Tensor, s_far: torch.Tensor) -> RaySamples:
    euclidean = spacing_fn_inv(kind, bins * s_far + (1 - bins) * s_near)
    starts = euclidean[..., :-1, None]
    ends = euclidean[..., 1:, None]
    return RaySamples(origins=ray_bundle.origins[..., None, :],
                      directions=ray_bundle.directions[..., None, :],
                      starts=starts, ends=ends, deltas=ends - starts,
                      spacing_starts=bins[..., :-1, None],
                      spacing_ends=bins[..., 1:, None],
                      s_near=s_near, s_far=s_far, spacing=kind)


def spaced_sample(ray_bundle: RayBundle, num_samples: int, kind: str = "uniform",
                  stratified: bool = True, single_jitter: bool = False,
                  generator=None, t_rand=None) -> RaySamples:
    """Spaced sampling; stratified=False gives the deterministic bin edges.
    Stratified jitter is `t_rand` in [0, 1) ([..., 1 or num_samples + 1])
    when given, else drawn from `generator`."""
    o = ray_bundle.origins
    batch_shape = o.shape[:-1]
    bins = torch.linspace(0.0, 1.0, num_samples + 1, dtype=o.dtype, device=o.device)
    bins = bins.expand(*batch_shape, num_samples + 1)
    if stratified:
        if t_rand is None:
            shape = (*batch_shape, 1 if single_jitter else num_samples + 1)
            t_rand = torch.rand(shape, generator=generator, dtype=o.dtype, device=o.device)
        centers = (bins[..., 1:] + bins[..., :-1]) / 2.0
        upper = torch.cat([centers, bins[..., -1:]], dim=-1)
        lower = torch.cat([bins[..., :1], centers], dim=-1)
        bins = lower + (upper - lower) * t_rand.to(dtype=o.dtype, device=o.device)
    return _from_spacing_bins(ray_bundle, bins, kind, spacing_fn(kind, ray_bundle.nears),
                              spacing_fn(kind, ray_bundle.fars))


def pdf_sample(ray_bundle: RayBundle, ray_samples: RaySamples, weights: torch.Tensor,
               num_samples: int, stratified: bool = True, single_jitter: bool = False,
               include_original: bool = False, histogram_padding: float = 0.01,
               use_pallas: bool = False, generator=None, jitter=None) -> RaySamples:
    """PDF resampling in spacing coordinates; use_pallas routes through the
    K5 wrapper (same distribution; bin-boundary ties may resolve to the
    adjacent bin, see csrc/pdf_resample.cu). Stratified jitter is `jitter`
    when given, else drawn from `generator` (ops/pdf.pdf_queries). The new
    bins are gradient-stopped."""
    existing_bins = sdist_edges(ray_samples).detach()
    w = weights[..., 0].detach()
    u = pdf_queries(existing_bins.shape[:-1], num_samples, stratified, single_jitter,
                    generator, existing_bins.device, existing_bins.dtype, jitter)
    if use_pallas and not include_original:
        from ..ops.kernels.pdf_resample import fused_sample_pdf

        bins = fused_sample_pdf(existing_bins, w, u.float(), histogram_padding)
    else:
        bins = sample_pdf(existing_bins, w, num_samples, stratified, single_jitter,
                          include_original, histogram_padding, u=u)
    return _from_spacing_bins(ray_bundle, bins, ray_samples.spacing, ray_samples.s_near,
                              ray_samples.s_far)


@dataclass(frozen=True)
class ProposalSamplerCfg:
    num_proposal_samples: Tuple[int, ...] = (256,)
    num_nerf_samples: int = 256
    single_jitter: bool = False
    initial_spacing: str = "uniform"
    use_pallas_pdf: bool = False


def proposal_anneal(step: int, max_num_iters: int, slope: float) -> float:
    """Proposal weight anneal exponent (mip-NeRF 360 eq. 18 bias)."""
    train_frac = min(max(step / max_num_iters, 0.0), 1.0)
    return (slope * train_frac) / ((slope - 1.0) * train_frac + 1.0)


def proposal_sample(ray_bundle: RayBundle,
                    density_fns: Sequence[Callable[[torch.Tensor], torch.Tensor]],
                    cfg: ProposalSamplerCfg, anneal: float = 1.0, updated: bool = True,
                    stratified: bool = True, generator=None, draws=None):
    """Hierarchical proposal sampling. density_fns map world positions
    [B, R, S, 3] -> densities [B, R, S, 1]; the proposal weights are raised
    to `anneal` before resampling. `updated` is the proposal gate, given by
    the host: when False the proposal densities are evaluated under
    torch.no_grad() (the reference's own gate), so the proposal networks take
    no backward. `draws`, when given, holds the stratified jitter of each
    level in [0, 1) (level 0: the spaced sample's, then each resample's);
    else it is drawn from `generator`. Returns (final RaySamples,
    weights_list, ray_samples_list)."""
    n = len(density_fns)
    if n != len(cfg.num_proposal_samples):
        raise ValueError("one density function per proposal level")
    if draws is not None and len(draws) != n + 1:
        raise ValueError(f"draws: one per level ({n + 1}), got {len(draws)}")
    weights_list, ray_samples_list = [], []
    weights = ray_samples = None
    for i_level in range(n + 1):
        is_prop = i_level < n
        num_samples = cfg.num_proposal_samples[i_level] if is_prop else cfg.num_nerf_samples
        draw = None if draws is None else draws[i_level]
        if i_level == 0:
            ray_samples = spaced_sample(ray_bundle, num_samples, cfg.initial_spacing,
                                        stratified, cfg.single_jitter, generator, draw)
        else:
            ray_samples = pdf_sample(ray_bundle, ray_samples, weights ** anneal, num_samples,
                                     stratified, cfg.single_jitter, False,
                                     use_pallas=cfg.use_pallas_pdf, generator=generator,
                                     jitter=draw)
        if is_prop:
            with torch.set_grad_enabled(updated and torch.is_grad_enabled()):
                density = density_fns[i_level](ray_samples.get_positions())
            weights = ray_samples.get_weights(density)
            weights_list.append(weights)
            ray_samples_list.append(ray_samples)
    return ray_samples, weights_list, ray_samples_list
