"""Density activations (PyTorch counterpart of ops/activations.py).

`trunc_exp` is exp with a gradient taken at the clamped input: forward
exp(x), backward g * exp(clamp(x, -15, 15)) (the JAX custom_jvp)."""

import torch


class TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return TruncExp.apply(x)


def density_activation(kind: str = "trunc_exp"):
    """`trunc_exp` shifts the input by -1 so a zero head starts at exp(-1)."""
    if kind == "trunc_exp":
        return lambda x: trunc_exp(x - 1.0)
    if kind == "relu":
        return torch.relu
    raise ValueError(f"unknown density activation: {kind}")
