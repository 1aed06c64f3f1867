"""Residual fully-connected field trunk (PyTorch counterpart of
models/resnet_fc.py).

Three forms, chosen by configuration as in the JAX package:
  - the tz branch (fused_trunk, bf16 compute, knot features): the latent
    projection is done on the knots (KnotFeatures.project_then_interp) and
    the whole trunk runs in the K7-tz kernels (ops/kernels/field_mlp.py:
    K7-tz-fwd forward, K7-tz-bwd backward), which take their plain versions
    on a CPU tensor;
  - the level-split branch (fused_trunk, bf16 compute, the exact path's
    per-level features): the K7 kernels (K7-fwd, K7-bwd) project the latent
    levels themselves, with no [N, 512] concatenation;
  - the plain chain (f32 models, or fused_trunk off): lin_in, the fused lin_z
    projection added to the first combine_layer blocks, the residual blocks,
    relu, lin_out — nn.Linear layers computed in the compute dtype, on the
    levels concatenated.
The JAX package resolves the fused branch by backend (TPU only); the port
resolves it by configuration, and the kernel wrapper by the tensor's device.
`compute_features` (the flow decoder's head) takes the plain chain and
returns the block outputs too, as JAX's does. `remat` (the JAX
`nn.remat(ResnetFC)` of a Model built with remat=True) evaluates the trunk
under torch.utils.checkpoint: its activations are recomputed in the
backward instead of kept.
"""

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.epipolar import KnotFeatures
from ..utils import profiling
from . import initializers as init


@dataclass(frozen=True)
class MlpCfg:
    n_blocks: int = 5
    d_hidden: int = 128
    combine_layer: int = 3
    combine_type: str = "mean"
    beta: float = 0.0  # >0 -> softplus(beta), else ReLU


def _linear(x: torch.Tensor, layer: nn.Linear, dt) -> torch.Tensor:
    if dt is None:
        return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))
    return F.linear(x.to(dt), layer.weight.to(dt), layer.bias.to(dt))


class ResnetFC(nn.Module):
    """forward(z, x[, compute_features]): z = latent features [..., d_latent]
    (or KnotFeatures, or a tuple of levels whose widths sum to d_latent), x =
    encoded coords [..., d_in]. Returns output [..., d_out] float32.
    Layer names match the JAX param tree."""

    def __init__(self, cfg: MlpCfg, d_in: int, d_out: int, d_latent: int,
                 compute_dtype: Optional[torch.dtype] = None,
                 near_zero_init: bool = False, fused_trunk: bool = False,
                 remat: bool = False):
        super().__init__()
        self.cfg, self.d_in, self.d_out, self.d_latent = cfg, d_in, d_out, d_latent
        self.compute_dtype = compute_dtype
        self.near_zero_init = near_zero_init
        self.fused_trunk = fused_trunk
        self.remat = remat
        dh = cfg.d_hidden
        self.n_lin_z = min(cfg.combine_layer, cfg.n_blocks) if d_latent > 0 else 0
        self.lin_in = nn.Linear(d_in, dh)
        for i in range(self.n_lin_z):
            self.add_module(f"lin_z_{i}", nn.Linear(d_latent, dh))
        for i in range(cfg.n_blocks):
            self.add_module(f"blocks_{i}_fc_0", nn.Linear(dh, dh))
            self.add_module(f"blocks_{i}_fc_1", nn.Linear(dh, dh))
        self.lin_out = nn.Linear(dh, d_out)

    def init_weights(self, g):
        for name, layer in self.named_children():
            if self.near_zero_init:
                init.near_zero_normal_(layer.weight, g)
                init.near_zero_normal_(layer.bias, g)
                continue
            if name.endswith("_fc_1"):
                init.zeros_(layer.weight)
            else:
                init.kaiming_normal_in_(layer.weight, g)
            init.zeros_(layer.bias)

    def _layer(self, name) -> nn.Linear:
        return getattr(self, name)

    def trunk_params(self, tz_mode: bool):
        """The Flax-layout param dict K7-tz takes ({"kernel": [in, out],
        "bias"}); in tz mode the lin_z entries carry their bias only."""
        params = {}
        for name, layer in self.named_children():
            if tz_mode and name.startswith("lin_z_"):
                params[name] = {"bias": layer.bias}
            else:
                params[name] = {"kernel": layer.weight.t(), "bias": layer.bias}
        return params

    def _act(self, v):
        if self.cfg.beta > 0:
            return F.softplus(self.cfg.beta * v) / self.cfg.beta
        return torch.relu(v)

    def forward(self, z, x: torch.Tensor, compute_features: bool = False):
        """The output [..., d_out] float32; with compute_features, (output,
        the block outputs concatenated [..., n_blocks * d_hidden] float32).
        A "field" layer of utils/profiling.py."""
        with profiling.layer("field") as lay:
            if self.remat and torch.is_grad_enabled():
                # the trunks draw no randomness (every draw is passed in), so no
                # RNG state is kept for the recompute: reading the CUDA RNG state
                # would fail inside a CUDA-graph capture
                return lay.output(checkpoint(self._forward, z, x, compute_features,
                                             use_reentrant=False, preserve_rng_state=False))
            return lay.output(self._forward(z, x, compute_features))

    def _forward(self, z, x: torch.Tensor, compute_features: bool):
        cfg, dt = self.cfg, self.compute_dtype
        use_fused = (self.fused_trunk and not compute_features and cfg.beta == 0
                     and self.d_latent > 0 and dt == torch.bfloat16)
        if use_fused:
            from ..ops.kernels.field_mlp import fused_resnet_fc_train, fused_resnet_fc_train_tz

            if isinstance(z, KnotFeatures) and self.n_lin_z > 0:
                wz_cat = torch.cat([self._layer(f"lin_z_{i}").weight.t()
                                    for i in range(self.n_lin_z)], dim=1)
                w_rows = list(torch.split(wz_cat, [lvl.shape[-1] for lvl in z.levels], dim=0))
                tz = z.project_then_interp(w_rows)
                return fused_resnet_fc_train_tz(self.trunk_params(tz_mode=True), cfg, tz, x,
                                                self.d_out)
            if isinstance(z, KnotFeatures):
                z = z.interp_levels()
            return fused_resnet_fc_train(self.trunk_params(tz_mode=False), cfg, z, x,
                                         self.d_out)

        if isinstance(z, KnotFeatures):
            z = z.concat()
        elif isinstance(z, (tuple, list)):
            z = torch.cat([t.float() for t in z], dim=-1)

        h = _linear(x, self.lin_in, dt)
        tz_parts = None
        if self.n_lin_z > 0:
            w_cat = torch.cat([self._layer(f"lin_z_{i}").weight
                               for i in range(self.n_lin_z)], dim=0)
            b_cat = torch.cat([self._layer(f"lin_z_{i}").bias
                               for i in range(self.n_lin_z)], dim=0)
            zt = z.to(dt) if dt is not None else z
            tz_all = F.linear(zt, w_cat.to(zt.dtype), b_cat.to(zt.dtype))
            tz_parts = torch.split(tz_all, cfg.d_hidden, dim=-1)
        features = []
        for i in range(cfg.n_blocks):
            if tz_parts is not None and i < self.n_lin_z:
                h = h + tz_parts[i]
            net = _linear(self._act(h), self._layer(f"blocks_{i}_fc_0"), dt)
            dx = _linear(self._act(net), self._layer(f"blocks_{i}_fc_1"), dt)
            h = h + dx
            if compute_features:
                features.append(h)
        out = _linear(self._act(h), self.lin_out, dt).to(torch.float32)
        if compute_features:
            return out, torch.cat(features, dim=-1).to(torch.float32)
        return out
