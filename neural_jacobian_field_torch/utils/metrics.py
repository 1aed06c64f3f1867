"""Evaluation metrics (PyTorch counterpart of utils/metrics.py): PSNR for
perception, flow end-point error and Jacobian error for action."""

from typing import Optional

import torch


def psnr(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio over all pixels (dB)."""
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))


def flow_epe(pred: torch.Tensor, target: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """End-point error of predicted flow [..., 2] (pixels), masked mean
    where a mask is given."""
    err = torch.linalg.vector_norm(pred - target, dim=-1)
    if mask is None:
        return torch.mean(err)
    return torch.sum(err * mask) / torch.clamp(torch.sum(mask), min=1.0)


def jacobian_error(pred_j: torch.Tensor, true_j: torch.Tensor) -> torch.Tensor:
    """Mean absolute error between Jacobian fields [..., A*3] or [..., A, 3]."""
    return torch.mean(torch.abs(pred_j - true_j))
