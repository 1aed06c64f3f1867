"""K5: fused inverse-CDF (PDF) resampling — CUDA kernel and its plain version.

Replaces neural_jacobian_field_tpu/ops/pallas/pdf_resample.py::fused_sample_pdf.
The kernel (csrc/pdf_resample.cu) runs one warp per ray, its CDF a warp scan;
see its header for what bounds it and the bin-tie tolerance. Unlike the JAX function, the CDF
queries `u` are an argument (ops/pdf.pdf_queries makes them), so the kernel,
its plain version and the JAX kernel can be given the same draws.

Dispatch is by device: a CUDA tensor launches the kernel (or raises), a CPU
tensor takes the plain version.
"""

import torch

from ..pdf import resample_bins
from .build import check_cuda_tensor, dispatch, load_kernels, stream_of
from .conv_suite import _on_device


def fused_sample_pdf_plain(existing_bins: torch.Tensor, weights: torch.Tensor,
                           u: torch.Tensor, histogram_padding: float = 0.01,
                           eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version: existing_bins [..., S+1], weights [..., S],
    u [..., Q] -> new edges [..., Q] float32, gradient-stopped."""
    return resample_bins(existing_bins.detach().float(), weights.detach().float(),
                         u.float(), histogram_padding, eps)


def _as_rows(t, d):
    """t as contiguous float32 rows [-1, d], without a copy (or the host time
    of the calls) where it already is one."""
    if t.dtype != torch.float32 or not t.is_contiguous():
        t = t.float().contiguous()
    return t.view(-1, d)


def _fused_sample_pdf_cuda(existing_bins, weights, u, histogram_padding, eps):
    s1, q = existing_bins.shape[-1], u.shape[-1]
    bins, w, uu = _as_rows(existing_bins, s1), _as_rows(weights, s1 - 1), _as_rows(u, q)
    n = bins.shape[0]
    if w.shape[0] != n or uu.shape[0] != n:
        raise ValueError(f"ray counts differ: bins {tuple(existing_bins.shape)}, "
                         f"weights {tuple(weights.shape)}, u {tuple(u.shape)}")
    for t, name in ((bins, "bins"), (w, "weights"), (uu, "u")):
        check_cuda_tensor(t, name, torch.float32)
    out = torch.empty((n, q), dtype=torch.float32, device=bins.device)
    if n:
        lib = load_kernels()
        with _on_device(bins):
            fused_sample_pdf.launches += 1
            lib.call("njf_pdf_resample", bins.data_ptr(), w.data_ptr(), uu.data_ptr(),
                     out.data_ptr(), n, s1 - 1, q, float(histogram_padding), float(eps),
                     stream_of(bins))
    return out.view(*existing_bins.shape[:-1], q)


def fused_sample_pdf(existing_bins: torch.Tensor, weights: torch.Tensor,
                     u: torch.Tensor, histogram_padding: float = 0.01,
                     eps: float = 1e-5) -> torch.Tensor:
    """K5 wrapper (same signature as the plain version)."""
    return dispatch(
        "fused_sample_pdf", existing_bins,
        lambda: _fused_sample_pdf_cuda(existing_bins, weights, u, histogram_padding, eps),
        lambda: fused_sample_pdf_plain(existing_bins, weights, u, histogram_padding, eps))


fused_sample_pdf.launches = 0
