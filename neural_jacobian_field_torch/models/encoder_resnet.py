"""PixelNeRF-style ResNet-34 feature-pyramid encoder (PyTorch counterpart of
models/encoder_resnet.py), NHWC end to end.

The stride-1 3x3 convs of the BasicBlocks go through the K9 kernel
(ops/kernels/conv_suite.py) when conv_impl="pallas"; the stem 7x7/2, the
stride-2 3x3s and the 1x1 projections are plain PyTorch convolutions, as
they were plain XLA in JAX. conv_impl="xla" sends every conv through
PyTorch's own convolution. BatchNorm has the Flax semantics (momentum 0.9,
biased variance), which torch.nn.BatchNorm2d does not: its momentum weighs
the batch, not the running value, and its running variance is unbiased. Like
the JAX `__call__(x, train)`, `forward(rgb, train)` normalises with the
running statistics in eval mode and with the batch's in training mode,
updating the running buffers in place. The group/instance norms and the K10
conv_impl="pallas_fused" are not ported.
"""

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels import conv_suite as k9
from ..ops.pixel_gather import FeaturePyramid
from . import initializers as init


@dataclass(frozen=True)
class EncoderResnetCfg:
    name: str = "resnet"
    upsample_interp: str = "bilinear"
    num_layers: int = 4
    use_first_pool: bool = True
    norm_type: str = "group"  # batch | instance | group | none
    feature_layout: str = "pyramid"  # pyramid | concat
    conv_impl: str = "xla"  # xla | pallas (pallas_fused, the K10 fold: not ported)


_RESNET34_STAGES: Sequence = ((3, 64), (4, 128), (6, 256), (3, 512))


class ConvHWIO(nn.Module):
    """Bias-free conv whose kernel is stored HWIO [kh, kw, in, out] (the JAX
    layout, which K9 reads as [9C, Cout] without a copy)."""

    def __init__(self, cin: int, cout: int, ksize: int, stride: int,
                 conv_impl: str = "xla"):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(ksize, ksize, cin, cout))
        self.ksize, self.stride, self.conv_impl = ksize, stride, conv_impl

    def init_weights(self, g):
        init.kaiming_normal_out_(self.weight, g)

    def forward(self, x):
        w = self.weight.to(x.dtype)
        if self.conv_impl == "pallas" and self.ksize == 3:
            return k9.conv3x3(x, w, self.stride)
        if self.conv_impl == "pallas" and self.ksize == 1:
            return k9.conv1x1(x, w, self.stride)
        return k9.conv_nhwc(x, w, self.stride, (self.ksize - 1) // 2)


class BatchNorm(nn.Module):
    """Flax nn.BatchNorm(momentum=0.9, epsilon=1e-5) over (B, H, W): params
    {weight (scale), bias}, buffers {running_mean, running_var}. Training mode
    takes the batch mean and the biased batch variance, E[y^2] - E[y]^2
    clamped at 0, in float32 (Flax's fast variance), differentiates through
    them, and moves running = 0.9 running + 0.1 batch. Both modes compute
    (y - mean) * (rsqrt(var + eps) * scale) + bias in float32 and cast back
    once."""

    MOMENTUM = 0.9  # Flax's: running = MOMENTUM * running + (1 - MOMENTUM) * batch

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.eps = eps

    def init_weights(self, g=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, y, train: bool = False):
        at = torch.promote_types(y.dtype, torch.float32)
        if train:
            yf = y.to(at)
            mean = yf.mean(dim=(0, 1, 2))
            var = torch.clamp((yf * yf).mean(dim=(0, 1, 2)) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean.float())
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var.float())
        else:
            mean, var = self.running_mean.to(at), self.running_var.to(at)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(at)
        out = (y.to(at) - mean) * mul + self.bias.to(at)
        return out.to(y.dtype)


class _NoNorm(nn.Module):
    def forward(self, y, train: bool = False):
        return y


def _norm(norm_type: str, c: int):
    if norm_type == "batch":
        return BatchNorm(c)
    if norm_type == "none":
        return _NoNorm()
    raise NotImplementedError(f"norm_type={norm_type!r} is not ported (batch, none are)")


def _init(m, g):
    if hasattr(m, "init_weights"):
        m.init_weights(g)


class BasicBlock(nn.Module):
    """ResNet basic block: two 3x3 convs + identity or 1x1 projection."""

    def __init__(self, cin: int, channels: int, strides: int, norm_type: str,
                 conv_impl: str = "xla"):
        super().__init__()
        self.conv1 = ConvHWIO(cin, channels, 3, strides, conv_impl)
        self.bn1 = _norm(norm_type, channels)
        self.conv2 = ConvHWIO(channels, channels, 3, 1, conv_impl)
        self.bn2 = _norm(norm_type, channels)
        self.needs_proj = strides != 1 or cin != channels
        if self.needs_proj:
            self.downsample_conv = ConvHWIO(cin, channels, 1, strides, conv_impl)
            self.downsample_norm = _norm(norm_type, channels)

    def init_weights(self, g):
        for m in self.children():
            _init(m, g)

    def forward(self, x, train: bool = False):
        y = torch.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        residual = x
        if self.needs_proj:
            residual = self.downsample_norm(self.downsample_conv(x), train)
        return torch.relu(y + residual)


class EncoderResnet(nn.Module):
    """ResNet-34 multi-scale feature extractor: rgb [B, H, W, 3] ->
    FeaturePyramid (feature_layout="pyramid", num_layers=4) or one
    [B, H/2, W/2, C_total] map ("concat")."""

    def __init__(self, cfg: EncoderResnetCfg, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if cfg.conv_impl not in ("xla", "pallas"):
            raise NotImplementedError(f"conv_impl={cfg.conv_impl!r} is not ported")
        self.cfg, self.compute_dtype = cfg, compute_dtype
        self.conv1 = ConvHWIO(3, 64, 7, 2, "xla")
        self.bn1 = _norm(cfg.norm_type, 64)
        cin = 64
        self.block_names = []
        for stage_idx in range(cfg.num_layers - 1):
            num_blocks, channels = _RESNET34_STAGES[stage_idx]
            strides = 1 if stage_idx == 0 else 2
            for block_idx in range(num_blocks):
                name = f"layer{stage_idx + 1}_block{block_idx}"
                self.add_module(name, BasicBlock(cin, channels,
                                                 strides if block_idx == 0 else 1,
                                                 cfg.norm_type, cfg.conv_impl))
                self.block_names.append((stage_idx, name))
                cin = channels

    @staticmethod
    def output_dim(cfg: EncoderResnetCfg) -> int:
        return 64 + sum(_RESNET34_STAGES[i][1] for i in range(cfg.num_layers - 1))

    def init_weights(self, g):
        for m in self.children():
            _init(m, g)

    def forward(self, rgb: torch.Tensor, train: bool = False):
        cfg, dt = self.cfg, self.compute_dtype
        x = rgb.to(dt) if dt is not None else rgb
        x = torch.relu(self.bn1(self.conv1(x), train))
        latents = [x]
        if cfg.use_first_pool and cfg.num_layers > 1:
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1)
            x = x.permute(0, 2, 3, 1).contiguous()
        stage = 0
        for stage_idx, name in self.block_names:
            if stage_idx != stage:
                latents.append(x)
                stage = stage_idx
            x = getattr(self, name)(x, train)
        if self.block_names:
            latents.append(x)

        target_hw = latents[0].shape[1:3]

        def up_to_fine(lat):
            # bilinear, half-pixel centres (align_corners=False): for
            # upsampling, jax.image.resize "linear"
            y = F.interpolate(lat.permute(0, 3, 1, 2), size=tuple(target_hw),
                              mode="bilinear", align_corners=False)
            return y.permute(0, 2, 3, 1).contiguous()

        if cfg.feature_layout == "pyramid" and cfg.num_layers == 4:
            return FeaturePyramid(fine=torch.cat([latents[0], up_to_fine(latents[1])], dim=-1),
                                  mid=latents[2], coarse=latents[3])
        resized = [latents[0]] + [up_to_fine(lat) for lat in latents[1:]]
        out = torch.cat(resized, dim=-1)
        return out.to(torch.float32) if dt is not None else out
