"""Seeded weight initializers with the JAX package's distributions
(models/initializers.py), drawn from a torch.Generator.

Layouts: linear weights are torch's [out, in]; conv kernels are HWIO
[kh, kw, in, out] as in the JAX package.
  - kaiming_normal_in: N(0, 2 / fan_in) (ResnetFC input/latent/output
    linears and block fc_0);
  - kaiming_normal_out: N(0, 2 / fan_out) (encoder convs);
  - torch_linear: U(+-sqrt(1 / fan_in)) (colour head);
  - near_zero_normal: N(0, 1e-4^2) (every linear of the Jacobian head);
  - truncated_normal: the variance-scaling truncated normal (lecun_normal,
    Flax's Dense / Conv default, and xavier_normal: the 2D family);
  - zeros (block fc_1, biases).
"""

import math

import torch


def _fans(t: torch.Tensor, layout: str):
    if layout == "linear":  # [out, in]
        return t.shape[1], t.shape[0]
    if layout == "hwio":
        rf = t.shape[0] * t.shape[1]
        return t.shape[2] * rf, t.shape[3] * rf
    raise ValueError(layout)


@torch.no_grad()
def normal_(t: torch.Tensor, std: float, generator=None) -> torch.Tensor:
    t.copy_(torch.randn(t.shape, generator=generator, dtype=torch.float32) * std)
    return t


@torch.no_grad()
def truncated_normal_(t: torch.Tensor, std: float, generator=None) -> torch.Tensor:
    """jax.nn.initializers' "truncated_normal" variance scaling: N(0, 1)
    truncated to [-2, 2], times std / 0.87962566 (the truncated unit
    normal's standard deviation), so the draw's variance is std^2."""
    u = torch.empty(t.shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(u, 0.0, 1.0, -2.0, 2.0, generator=generator)
    t.copy_(u * (std / 0.87962566103423978))
    return t


@torch.no_grad()
def uniform_(t: torch.Tensor, limit: float, generator=None) -> torch.Tensor:
    u = torch.rand(t.shape, generator=generator, dtype=torch.float32)
    t.copy_((u * 2.0 - 1.0) * limit)
    return t


def kaiming_normal_in_(t, generator=None, layout="linear"):
    fan_in, _ = _fans(t, layout)
    return normal_(t, math.sqrt(2.0 / fan_in), generator)


def kaiming_normal_out_(t, generator=None, layout="hwio"):
    _, fan_out = _fans(t, layout)
    return normal_(t, math.sqrt(2.0 / fan_out), generator)


def torch_linear_(t, generator=None, layout="linear"):
    fan_in, _ = _fans(t, layout)
    return uniform_(t, math.sqrt(1.0 / fan_in), generator)


def near_zero_normal_(t, generator=None, std: float = 1e-4):
    return normal_(t, std, generator)


@torch.no_grad()
def zeros_(t, generator=None):
    return t.zero_()
