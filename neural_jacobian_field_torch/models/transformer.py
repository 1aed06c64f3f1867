"""Pre-norm transformer with cross-attention (PyTorch counterpart of
models/transformer.py).

Used by the jacobian_transformer action decoder: each point's query token
cross-attends into `action_dim` learned index embeddings. The key/value
length is action_dim (8), so attention is two batched matmuls and a softmax,
written as the JAX module computes it: the scores and the weighted sum in the
compute dtype, the softmax in float32 and cast back, exact-erf GELU, and
pre-norm LayerNorms with Flax's epsilon (1e-6), statistics in float32
(E[x^2] - E[x]^2, clamped at 0) and one cast to the compute dtype at the
end. F.scaled_dot_product_attention is not used: its backends compute the
softmax in bf16, and some sum their backward with atomics. Parameter names
follow the Flax tree (utils/from_jax.py): to_qkv / to_q / to_kv without
bias, to_out, fc1 / fc2, layers_{i}_attn_norm / layers_{i}_ff_norm
({scale, bias} as {weight, bias}).
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels import attn_layer as attn_kernels
from ..utils import profiling
from . import initializers as init


def dense(x: torch.Tensor, layer: nn.Linear, dt: Optional[torch.dtype]) -> torch.Tensor:
    """Flax nn.Dense(dtype=dt): input, kernel and bias in dt; with dt None in
    the promoted type of the input and the float32 parameters."""
    dt = dt or torch.promote_types(x.dtype, layer.weight.dtype)
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), bias)


def _init_linears(module: nn.Module, g) -> None:
    """torch_linear kernels, zero biases (the JAX modules' initializers)."""
    for layer in module.modules():
        if isinstance(layer, nn.Linear):
            init.torch_linear_(layer.weight, g)
            if layer.bias is not None:
                init.zeros_(layer.bias)


class LayerNorm(nn.Module):
    """Flax nn.LayerNorm(dtype=dt) over the last axis: mean and E[x^2] -
    mean^2 (clamped at 0) in float32, (x - mean) * (rsqrt(var + eps) *
    scale) + bias in float32, cast to dt (float32 where dt is None)."""

    def __init__(self, dim: int, compute_dtype: Optional[torch.dtype] = None,
                 eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.compute_dtype, self.eps = compute_dtype, eps

    def init_weights(self, g=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        at = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(at)
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight.to(at)) + self.bias.to(at)
        return y.to(self.compute_dtype or at)


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)
        self.compute_dtype = compute_dtype

    def init_weights(self, g):
        _init_linears(self, g)

    def forward(self, x):
        dt = self.compute_dtype
        return dense(F.gelu(dense(x, self.fc1, dt)), self.fc2, dt)


class Attention(nn.Module):
    """Multi-head attention; cross-attention into `z` when selfatt is False."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, selfatt: bool = True,
                 kv_dim: Optional[int] = None, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        inner = dim_head * heads
        self.heads, self.dim_head, self.selfatt = heads, dim_head, selfatt
        self.compute_dtype = compute_dtype
        if selfatt:
            self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        else:
            self.to_q = nn.Linear(dim, inner, bias=False)
            self.to_kv = nn.Linear(kv_dim or dim, inner * 2, bias=False)
        self.to_out = (nn.Linear(inner, dim) if not (heads == 1 and dim_head == dim)
                       else None)

    def init_weights(self, g):
        _init_linears(self, g)

    def _split_heads(self, t):
        return t.reshape(*t.shape[:-1], self.heads, self.dim_head).transpose(-3, -2)

    def forward(self, x, z=None):
        dt = self.compute_dtype
        if self.selfatt:
            q, k, v = dense(x, self.to_qkv, dt).chunk(3, dim=-1)
        else:
            q = dense(x, self.to_q, dt)
            k, v = dense(z, self.to_kv, dt).chunk(2, dim=-1)
        q, k, v = map(self._split_heads, (q, k, v))
        dots = torch.matmul(q, k.transpose(-1, -2)) * self.dim_head ** -0.5
        attn = torch.softmax(dots.float(), dim=-1).to(dots.dtype)
        out = torch.matmul(attn, v).transpose(-3, -2)
        out = out.reshape(*out.shape[:-2], self.heads * self.dim_head)
        return out if self.to_out is None else dense(out, self.to_out, dt)


class Transformer(nn.Module):
    """Stack of pre-norm attention + feed-forward blocks; forward(x, z) with
    x [..., N, dim] tokens and z [..., M, kv_dim] the cross-attention's
    keys and values (None for self-attention). Where `_fused` holds (the
    Jacobian decoder's bf16 layers: dim 64, 8 heads of 64, hidden <= 64, at
    most 8 keys, a float32 residual), each layer is one call of
    ops/kernels/attn_layer.py (JT-fwd / JT-bwd on the card, their plain
    version on the CPU), counted per point and layer in the program's
    `attn_fused_points`; every other module runs the per-op code below."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int,
                 selfatt: bool = True, kv_dim: Optional[int] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.depth, self.compute_dtype = depth, compute_dtype
        for i in range(depth):
            self.add_module(f"layers_{i}_attn_norm", LayerNorm(dim, compute_dtype))
            self.add_module(f"layers_{i}_attn", Attention(dim, heads, dim_head, selfatt,
                                                          kv_dim, compute_dtype))
            self.add_module(f"layers_{i}_ff_norm", LayerNorm(dim, compute_dtype))
            self.add_module(f"layers_{i}_ff", FeedForward(dim, mlp_dim, compute_dtype))

    def init_weights(self, g):
        for m in self.children():
            m.init_weights(g)

    def _fused(self, x, z) -> bool:
        """Whether each layer takes the fused kernels (ops/kernels/attn_layer.py):
        bf16 compute, cross-attention into one set of keys, the kernels'
        widths, a float32 residual."""
        if (self.depth == 0 or self.compute_dtype != torch.bfloat16 or z is None
                or x.dtype != torch.float32 or z.dim() != 3 or z.shape[0] != 1):
            return False
        attn, ff = self.layers_0_attn, self.layers_0_ff
        return (not attn.selfatt and attn.to_out is not None
                and attn_kernels.supported(x.shape[-1], attn.heads, attn.dim_head,
                                           ff.fc1.out_features, z.shape[1]))

    def _fused_forward(self, x, z):
        for i in range(self.depth):
            attn, ff = getattr(self, f"layers_{i}_attn"), getattr(self, f"layers_{i}_ff")
            an, fn = getattr(self, f"layers_{i}_attn_norm"), getattr(self, f"layers_{i}_ff_norm")
            k, v = dense(z[0], attn.to_kv, self.compute_dtype).chunk(2, dim=-1)
            p = attn_kernels.LayerWeights(an.weight, an.bias, attn.to_q.weight,
                                          attn.to_out.weight, attn.to_out.bias, fn.weight,
                                          fn.bias, ff.fc1.weight, ff.fc1.bias, ff.fc2.weight,
                                          ff.fc2.bias)
            profiling.attn_fused_points(x.numel() // x.shape[-1])
            x = attn_kernels.attn_layer(x, k, v, p, attn.dim_head ** -0.5)
        return x

    def forward(self, x, z=None):
        if self._fused(x, z):
            return self._fused_forward(x, z)
        for i in range(self.depth):
            x = x + getattr(self, f"layers_{i}_attn")(getattr(self, f"layers_{i}_attn_norm")(x),
                                                      z)
            x = x + getattr(self, f"layers_{i}_ff")(getattr(self, f"layers_{i}_ff_norm")(x))
        return x
