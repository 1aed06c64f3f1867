"""PixelNeRF-style ResNet-34 feature-pyramid encoder (PyTorch counterpart of
models/encoder_resnet.py), NHWC end to end.

The stride-1 3x3 convs of the BasicBlocks go through the K9 kernel
(ops/kernels/conv_suite.py) when conv_impl="pallas"; the stem 7x7/2, the
stride-2 3x3s and the 1x1 projections are plain PyTorch convolutions, as
they were plain XLA in JAX. conv_impl="xla" sends every conv through
PyTorch's own convolution. conv_impl="pallas_fused" is "pallas" plus the K10
fold: in training mode with BatchNorm, each stride-1 3x3 conv on JAX's
shape family returns the per-channel sum and sum of squares of its output
from the kernel's float32 accumulator, and its BatchNorm takes its batch
statistics from them instead of reading the output again (the JAX
`_ConvK9(emit_stats=True)` and `BatchNormFromStats`). The family is where
JAX's `conv3x3_supported` holds (an output height with a divisor in 4..16,
W >= 2, the assembled operand within 6 MiB; `conv3x3_s1_supported` is the
port's copy); off it JAX runs the conv through XLA and BatchNorm sums y
itself, and so does the port, though its conv still runs K9 (which takes
every shape). The stem, the stride-2 convs and the projections keep
computing their own statistics, as in JAX. In eval mode, or with another
norm, it is "pallas". The parameter tree is the same for all three.
BatchNorm has the Flax semantics (momentum 0.9,
biased variance), which torch.nn.BatchNorm2d does not: its momentum weighs
the batch, not the running value, and its running variance is unbiased. Like
the JAX `__call__(x, train)`, `forward(rgb, train)` normalises with the
running statistics in eval mode and with the batch's in training mode,
updating the running buffers in place. The group norm (32 groups, affine)
and the instance norm (a group per channel, no scale or bias) have Flax's
GroupNorm semantics (`GroupNorm`): no running statistics, the same in
training and eval mode. K10 stays with BatchNorm, as in JAX. The
upsampling of the coarser levels to the fine one takes its gradient in a
fixed order (`ops/deterministic.py`), and the stem's max-pool's CUDA
backward is a gather already, so a train step repeats bit for bit.
"""

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.deterministic import upsample_bilinear
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
    conv_impl: str = "xla"  # xla | pallas | pallas_fused (K9 + the K10 BatchNorm-stats fold)


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

    def emits_stats(self, x) -> bool:
        """Whether `forward(x, stats=True)` returns K10's statistics for this
        x: a stride-1 3x3 conv under pallas_fused, x on JAX's shape family."""
        return (self.conv_impl == "pallas_fused" and self.ksize == 3 and self.stride == 1
                and k9.conv3x3_s1_supported(tuple(x.shape), x.element_size()))

    def forward(self, x, stats: bool = False):
        """y, or (y, s1, s2) with `stats` where `emits_stats(x)` holds: s1,
        s2 the per-channel float32 sum and sum of squares of y's accumulator
        over (B, H, W)."""
        w = self.weight.to(x.dtype)
        if stats and self.emits_stats(x):
            return k9.conv_s1_stats(x, w)
        pallas = self.conv_impl in ("pallas", "pallas_fused")
        if pallas and self.ksize == 3:
            return k9.conv3x3(x, w, self.stride)
        if pallas and self.ksize == 1:
            return k9.conv1x1(x, w, self.stride)
        return k9.conv_nhwc(x, w, self.stride, (self.ksize - 1) // 2)


class BatchNorm(nn.Module):
    """Flax nn.BatchNorm(momentum=0.9, epsilon=1e-5) over (B, H, W): params
    {weight (scale), bias}, buffers {running_mean, running_var}. Training mode
    takes the batch mean and the biased batch variance, E[y^2] - E[y]^2
    clamped at 0, in float32 (Flax's fast variance), differentiates through
    them, and moves running = 0.9 running + 0.1 batch. Given the per-channel
    sum s1 and sum of squares s2 of y over (B, H, W) (K10), training mode
    takes mean = s1 / n and var = max(s2 / n - mean^2, 0), n = B*H*W,
    instead (the JAX BatchNormFromStats). Both modes compute
    (y - mean) * (rsqrt(var + eps) * scale) + bias in float32 and cast back
    once. Inside a data-parallel step (parallel/mesh.py: an active mesh) the
    statistics are the global batch's, as under JAX's SPMD: the ranks' means
    of y and y^2 averaged over the ranks (the shards are equal), or their
    sums s1, s2 summed over the ranks with n the global count; the sums are
    differentiable, so the backward is the global batch's too, and the
    running statistics come out the same on every rank."""

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

    def forward(self, y, train: bool = False, s1=None, s2=None):
        at = torch.promote_types(y.dtype, torch.float32)
        if train:
            # imported here: the parallel package imports training's, which imports the models
            from ..parallel.mesh import active_mesh, all_reduce_sum

            mesh = active_mesh()
            if s1 is None:
                yf = y.to(at)
                mean = yf.mean(dim=(0, 1, 2))
                mean_sq = (yf * yf).mean(dim=(0, 1, 2))
                if mesh is not None:
                    mean, mean_sq = all_reduce_sum(torch.stack([mean, mean_sq]), mesh) / mesh.size
                var = torch.clamp(mean_sq - mean * mean, min=0.0)
            else:
                n = y.numel() // y.shape[-1]
                s1, s2 = s1.to(at), s2.to(at)
                if mesh is not None:
                    s1, s2 = all_reduce_sum(torch.stack([s1, s2]), mesh)
                    n *= mesh.size
                mean = s1 / n
                var = torch.clamp(s2 / n - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean.float())
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var.float())
        else:
            mean, var = self.running_mean.to(at), self.running_var.to(at)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(at)
        out = (y.to(at) - mean) * mul + self.bias.to(at)
        return out.to(y.dtype)


class GroupNorm(nn.Module):
    """Flax nn.GroupNorm(epsilon=1e-5) over NHWC: per example and group of
    channels, the mean and E[y^2] - mean^2 (clamped at 0) over (H, W, the
    group's channels) in float32, then (y - mean) * (rsqrt(var + eps) *
    scale) + bias in float32 and one cast back. `affine` False (the
    instance norm: a group per channel) has no scale or bias. The batch
    axis is never reduced, so training and eval mode are the same."""

    def __init__(self, c: int, num_groups: int, affine: bool = True, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        if affine:
            self.weight = nn.Parameter(torch.ones(c))
            self.bias = nn.Parameter(torch.zeros(c))
        else:
            self.weight = self.bias = None

    def init_weights(self, g=None):
        if self.weight is not None:
            with torch.no_grad():
                self.weight.fill_(1.0)
                self.bias.zero_()

    def forward(self, y, train: bool = False):
        c = y.shape[-1]
        groups = (self.num_groups, c // self.num_groups)
        at = torch.promote_types(y.dtype, torch.float32)
        yg = y.to(at).reshape(*y.shape[:-1], *groups)  # [B, H, W, G, C/G], a view
        mean = yg.mean(dim=(1, 2, 4), keepdim=True)
        var = torch.clamp((yg * yg).mean(dim=(1, 2, 4), keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight.to(at).reshape(groups)
        out = (yg - mean) * mul
        if self.bias is not None:
            out = out + self.bias.to(at).reshape(groups)
        return out.reshape(y.shape).to(y.dtype)


class _NoNorm(nn.Module):
    def forward(self, y, train: bool = False):
        return y


def _norm(norm_type: str, c: int):
    if norm_type == "batch":
        return BatchNorm(c)
    if norm_type == "group":
        return GroupNorm(c, 32)
    if norm_type == "instance":
        return GroupNorm(c, c, affine=False)
    if norm_type == "none":
        return _NoNorm()
    raise ValueError(f"unknown norm_type: {norm_type}")


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
        self.fuse_bn = conv_impl == "pallas_fused" and norm_type == "batch"
        if self.needs_proj:
            self.downsample_conv = ConvHWIO(cin, channels, 1, strides, conv_impl)
            self.downsample_norm = _norm(norm_type, channels)

    def init_weights(self, g):
        for m in self.children():
            _init(m, g)

    def _conv_norm(self, conv, norm, x, train):
        if self.fuse_bn and train and conv.emits_stats(x):
            y, s1, s2 = conv(x, stats=True)
            return norm(y, train, s1, s2)
        return norm(conv(x), train)

    def forward(self, x, train: bool = False):
        y = torch.relu(self._conv_norm(self.conv1, self.bn1, x, train))
        y = self._conv_norm(self.conv2, self.bn2, y, train)
        residual = x
        if self.needs_proj:
            residual = self.downsample_norm(self.downsample_conv(x), train)
        return torch.relu(y + residual)


def max_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, C] (NHWC) -> flax's nn.max_pool(x, (3, 3), strides=(2,
    2), padding=((1, 1), (1, 1))): each window's first maximum in row-major
    order gets its gradient, JAX's choice on ties. The CUDA backward gathers
    from the at most four windows that hold each pixel, in a fixed order."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


class EncoderResnet(nn.Module):
    """ResNet-34 multi-scale feature extractor: rgb [B, H, W, 3] ->
    FeaturePyramid (feature_layout="pyramid", num_layers=4) or one
    [B, H/2, W/2, C_total] map ("concat")."""

    def __init__(self, cfg: EncoderResnetCfg, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if cfg.conv_impl not in ("xla", "pallas", "pallas_fused"):
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
            x = max_pool_3x3s2(x)
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
            # upsampling, jax.image.resize "linear"; its backward in a fixed
            # order
            return upsample_bilinear(lat, tuple(target_hw))

        if cfg.feature_layout == "pyramid" and cfg.num_layers == 4:
            return FeaturePyramid(fine=torch.cat([latents[0], up_to_fine(latents[1])], dim=-1),
                                  mid=latents[2], coarse=latents[3])
        resized = [latents[0]] + [up_to_fine(lat) for lat in latents[1:]]
        out = torch.cat(resized, dim=-1)
        return out.to(torch.float32) if dt is not None else out
