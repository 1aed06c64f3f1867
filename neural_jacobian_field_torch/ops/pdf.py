"""Inverse-CDF (PDF) resampling along rays: the plain PyTorch version of
ops/pdf.py. `sample_pdf` is the oracle the K5 kernel
(ops/kernels/pdf_resample.py) is held against; the jitter `u` is an argument
or drawn from a torch.Generator, so kernel and oracle can be fed the same
draws."""

import torch


def searchsorted_right(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched searchsorted(side="right") over the last axis: counts of entries
    of a [..., M] (sorted ascending) that are <= each v [..., Q]."""
    return torch.searchsorted(a.contiguous(), v.contiguous(), right=True)


def pdf_queries(lead_shape, num_samples: int, stratified: bool = True,
                single_jitter: bool = False, generator=None,
                device=None, dtype=torch.float32, jitter=None) -> torch.Tensor:
    """The CDF queries u [..., num_samples + 1]: a regular grid, jittered
    within each cell when stratified (by `jitter` in [0, 1), [..., 1 or
    num_samples + 1], when given, else drawn from `generator`), else at the
    cell centres."""
    num_bins = num_samples + 1
    u = torch.linspace(0.0, 1.0 - 1.0 / num_bins, num_bins, dtype=dtype, device=device)
    u = u.expand(*lead_shape, num_bins)
    if stratified:
        if jitter is None:
            shape = (*lead_shape, 1 if single_jitter else num_bins)
            jitter = torch.rand(shape, generator=generator, dtype=dtype, device=device)
        return u + jitter.to(dtype=dtype, device=device) / num_bins
    return u + 0.5 / num_bins


def resample_bins(existing_bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor,
                  histogram_padding: float = 0.01, eps: float = 1e-5) -> torch.Tensor:
    """New bin edges at CDF queries u. existing_bins [..., S+1] in [0, 1],
    weights [..., S] >= 0, u [..., Q] -> [..., Q] (gradient-stopped)."""
    weights = weights + histogram_padding
    weights_sum = torch.sum(weights, dim=-1, keepdim=True)
    padding = torch.relu(eps - weights_sum)
    weights = weights + padding / weights.shape[-1]
    weights_sum = weights_sum + padding

    pdf = weights / weights_sum
    cdf = torch.clamp(torch.cumsum(pdf, dim=-1), max=1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [..., S+1]

    inds = searchsorted_right(cdf, u)
    max_idx = existing_bins.shape[-1] - 1
    below = torch.clamp(inds - 1, 0, max_idx)
    above = torch.clamp(inds, 0, max_idx)
    cdf_g0 = torch.gather(cdf, -1, below)
    bins_g0 = torch.gather(existing_bins, -1, below)
    cdf_g1 = torch.gather(cdf, -1, above)
    bins_g1 = torch.gather(existing_bins, -1, above)

    denom = cdf_g1 - cdf_g0
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    t = torch.where(denom > 0, (u - cdf_g0) / safe, torch.zeros_like(denom))
    t = torch.clamp(torch.nan_to_num(t, nan=0.0), 0.0, 1.0)
    return (bins_g0 + t * (bins_g1 - bins_g0)).detach()


def sample_pdf(existing_bins: torch.Tensor, weights: torch.Tensor, num_samples: int,
               stratified: bool = True, single_jitter: bool = False,
               include_original: bool = False, histogram_padding: float = 0.01,
               eps: float = 1e-5, generator=None, u=None) -> torch.Tensor:
    """Resample bin edges proportional to weights (ops/pdf.py:sample_pdf).
    Returns [..., num_samples+1] sorted edges, or with include_original the
    original edges merged in. `u` overrides the drawn queries."""
    if u is None:
        u = pdf_queries(existing_bins.shape[:-1], num_samples, stratified,
                        single_jitter, generator, existing_bins.device,
                        existing_bins.dtype)
    bins = resample_bins(existing_bins, weights, u, histogram_padding, eps)
    if include_original:
        bins = torch.sort(torch.cat([existing_bins, bins], dim=-1), dim=-1).values
    return bins.detach()
