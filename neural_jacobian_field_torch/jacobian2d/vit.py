"""ViT-S/14 feature extractor, DINOv2's architecture (PyTorch counterpart of
jacobian2d/vit.py).

A 14x14 / 14 patch embedding, a cls token, learned position embeddings
resized to the input's patch grid, 12 pre-norm blocks (dim 384, 6 heads, MLP
x4 with exact GELU, LayerScale `ls1` / `ls2`), a final LayerNorm; the patch
tokens come out (the cls token dropped, as DINOv2's
get_intermediate_layers). The modules carry the Flax names (patch_embed,
block_<i>/qkv, attn_proj, mlp_fc1, ...) and are PyTorch's layers (Linear,
LayerNorm with Flax's epsilon 1e-6, Conv2d), so `utils/from_jax` bridges a
JAX param tree and `load_torch_dinov2_state_dict` a torch.hub DINOv2
checkpoint. Attention is plain matmuls, the softmax in float32 under a
reduced compute dtype, as JAX's. The position grid (37x37, DINOv2's 518 px)
is resized bilinearly with half-pixel centres and antialiased when it
shrinks, as jax.image.resize "linear" does (`flow/raft._resize`).

With no checkpoint the ViT has seeded random weights (Flax's initialisers:
lecun_normal Dense and Conv kernels, normal(0.02) tokens, LayerScale 1e-5).
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..flow.raft import _resize
from ..models import initializers as init

LN_EPS = 1e-6  # flax.linen.LayerNorm's default


@dataclass(frozen=True)
class ViTCfg:
    patch_size: int = 14
    dim: int = 384
    depth: int = 12
    heads: int = 6
    mlp_ratio: float = 4.0
    pos_grid: int = 37  # DINOv2's 518 / 14 training grid
    layerscale_init: float = 1e-5


def _dense(x, layer: nn.Linear):
    """A Dense in x's dtype (Flax's `dtype=`: kernel and bias cast)."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def _layer_norm(x, layer: nn.LayerNorm):
    return F.layer_norm(x, layer.normalized_shape, layer.weight.to(x.dtype),
                        layer.bias.to(x.dtype), layer.eps)


class Block(nn.Module):
    def __init__(self, cfg: ViTCfg):
        super().__init__()
        self.cfg = cfg
        hidden = int(cfg.dim * cfg.mlp_ratio)
        self.norm1 = nn.LayerNorm(cfg.dim, eps=LN_EPS)
        self.qkv = nn.Linear(cfg.dim, 3 * cfg.dim)
        self.attn_proj = nn.Linear(cfg.dim, cfg.dim)
        self.ls1 = nn.Parameter(torch.full((cfg.dim,), cfg.layerscale_init))
        self.norm2 = nn.LayerNorm(cfg.dim, eps=LN_EPS)
        self.mlp_fc1 = nn.Linear(cfg.dim, hidden)
        self.mlp_fc2 = nn.Linear(hidden, cfg.dim)
        self.ls2 = nn.Parameter(torch.full((cfg.dim,), cfg.layerscale_init))

    def forward(self, x, reduced: bool):
        cfg = self.cfg
        b, t, _ = x.shape
        hd = cfg.dim // cfg.heads
        qkv = _dense(_layer_norm(x, self.norm1), self.qkv)
        q, k, v = (u.reshape(b, t, cfg.heads, hd).transpose(1, 2)
                   for u in qkv.split(cfg.dim, dim=-1))
        logits = torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5
        if reduced:  # float32 softmax under bf16; nothing to do in float32 / 64
            logits = logits.float()
        attn = torch.softmax(logits, dim=-1).to(q.dtype)
        o = torch.matmul(attn, v).transpose(1, 2).reshape(b, t, cfg.dim)
        x = x + _dense(o, self.attn_proj) * self.ls1.to(x.dtype)
        h = _dense(_layer_norm(x, self.norm2), self.mlp_fc1)
        h = F.gelu(h)  # exact erf GELU (DINOv2's nn.GELU)
        return x + _dense(h, self.mlp_fc2) * self.ls2.to(x.dtype)


class ViTS14(nn.Module):
    """forward([B, H, W, 3]) -> patch tokens [B, (H/14)(W/14), dim]."""

    def __init__(self, cfg: ViTCfg = ViTCfg(), compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg, self.compute_dtype = cfg, compute_dtype
        p = cfg.patch_size
        self.patch_embed = nn.Conv2d(3, cfg.dim, p, stride=p)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.pos_grid * cfg.pos_grid + 1, cfg.dim))
        for i in range(cfg.depth):
            self.add_module(f"block_{i}", Block(cfg))
        self.norm = nn.LayerNorm(cfg.dim, eps=LN_EPS)

    def init_weights(self, g: torch.Generator) -> "ViTS14":
        """Flax's initialisers: lecun_normal (truncated normal, fan_in)
        kernels and zero biases, normal(0.02) cls token and position
        embeddings, LayerNorm ones and zeros, LayerScale at its init value."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = int(np.prod(m.weight.shape[1:]))
                init.truncated_normal_(m.weight, fan_in ** -0.5, g)
                init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                with torch.no_grad():
                    m.weight.fill_(1.0)
                    m.bias.zero_()
            elif isinstance(m, Block):
                with torch.no_grad():
                    m.ls1.fill_(self.cfg.layerscale_init)
                    m.ls2.fill_(self.cfg.layerscale_init)
        init.normal_(self.cls_token, 0.02, g)
        init.normal_(self.pos_embed, 0.02, g)
        return self

    def forward(self, x):
        cfg, dt = self.cfg, self.compute_dtype
        b, h, w, _ = x.shape
        gh, gw = h // cfg.patch_size, w // cfg.patch_size
        if dt is not None:
            x = x.to(dt)
        x = F.conv2d(x.permute(0, 3, 1, 2), self.patch_embed.weight.to(x.dtype),
                     self.patch_embed.bias.to(x.dtype), stride=cfg.patch_size)
        x = x.permute(0, 2, 3, 1).reshape(b, gh * gw, cfg.dim)
        pos = self.pos_embed
        patch_pos = pos[:, 1:].reshape(1, cfg.pos_grid, cfg.pos_grid, cfg.dim)
        if (gh, gw) != (cfg.pos_grid, cfg.pos_grid):
            patch_pos = _resize(patch_pos, (gh, gw))
        x = x + patch_pos.reshape(1, gh * gw, cfg.dim).to(x.dtype)
        cls = (self.cls_token + pos[:, :1]).expand(b, 1, cfg.dim).to(x.dtype)
        x = torch.cat([cls, x], dim=1)
        for i in range(cfg.depth):
            x = getattr(self, f"block_{i}")(x, dt is not None)
        x = _layer_norm(x, self.norm)
        out = x[:, 1:]
        # float32 only under a reduced compute dtype (a float64 run stays so)
        return out.float() if dt is not None else out


def load_torch_dinov2_state_dict(vit: ViTS14, state_dict, unused_out: list = None) -> ViTS14:
    """Load a torch.hub DINOv2 ViT-S/14 state dict (dinov2_vits14) into `vit`
    in place: hub names to the port's (blocks.<i>.attn.qkv -> block_<i>.qkv,
    attn.proj -> attn_proj, mlp.fc1 / fc2 -> mlp_fc1 / mlp_fc2,
    ls1.gamma -> ls1, patch_embed.proj -> patch_embed), every layout PyTorch's
    already. Leftover checkpoint tensors (besides `mask_token`, which
    get_intermediate_layers never reads) go to `unused_out` where given,
    else are printed, as the JAX loader reports them. Returns `vit`."""
    used = {"mask_token"}

    def t(name):
        used.add(name)
        return torch.as_tensor(np.asarray(state_dict[name]))

    new = {"patch_embed.weight": t("patch_embed.proj.weight"),
           "patch_embed.bias": t("patch_embed.proj.bias"),
           "cls_token": t("cls_token"), "pos_embed": t("pos_embed"),
           "norm.weight": t("norm.weight"), "norm.bias": t("norm.bias")}
    depth = len([k for k in state_dict if k.endswith("ls1.gamma")]) or 12
    for i in range(depth):
        p, q = f"block_{i}", f"blocks.{i}"
        for ours, theirs in (("norm1", "norm1"), ("qkv", "attn.qkv"), ("attn_proj", "attn.proj"),
                             ("norm2", "norm2"), ("mlp_fc1", "mlp.fc1"), ("mlp_fc2", "mlp.fc2")):
            new[f"{p}.{ours}.weight"] = t(f"{q}.{theirs}.weight")
            new[f"{p}.{ours}.bias"] = t(f"{q}.{theirs}.bias")
        new[f"{p}.ls1"] = t(f"{q}.ls1.gamma")
        new[f"{p}.ls2"] = t(f"{q}.ls2.gamma")
    leftovers = sorted(k for k in state_dict if k not in used)
    if unused_out is not None:
        unused_out.extend(leftovers)
    elif leftovers:
        print(f"load_torch_dinov2_state_dict: {len(leftovers)} unported checkpoint tensors: "
              f"{leftovers[:8]}{'...' if len(leftovers) > 8 else ''}")
    own = vit.state_dict()
    missing = sorted(set(own) - set(new))
    if missing:  # strict: every parameter of the ViT comes from the checkpoint
        raise KeyError(f"load_torch_dinov2_state_dict: the ViT's {missing[:4]} have no "
                       f"checkpoint tensor (depth {depth} against {vit.cfg.depth})")
    with torch.no_grad():
        for k, v in new.items():
            own[k].copy_(v.to(own[k].dtype))
    return vit
