"""RAFT optical flow (PyTorch counterpart of flow/raft.py), the helper that
precomputes the flow the stage-2 flow supervision reads.

The official RAFT (princeton-vl, ECCV'20) at raft_large's widths, in NHWC:
  - a feature encoder (instance norm) and a context encoder (frozen
    BatchNorm), residual CNNs to 1/8 resolution, 256 channels each; the
    context splits into hidden (128, tanh) and context (128, relu);
  - the all-pairs correlation volume, one batched matmul [N, HW, HW], and
    a 4-level average-pooled pyramid; radius-4 bilinear lookups in zeros
    mode through ops/grid_sample.py (81 offsets per level, the x offset
    varying slowest, as the official CorrBlock orders them);
  - a SepConvGRU update block iterated `num_iters` times (20 by default),
    a flow head and convex upsampling (the official 0.25 mask scale).
Convolutions are PyTorch's (cuDNN on the card), the counterparts of JAX's
lax.conv: RAFT reaches no Pallas kernel in JAX and none here. It sets no
global flag: float32 convolutions and matmuls take TF32 where the caller
allows it (torch.backends).

Submodules carry the Flax param tree's names (fnet/layer1_0/conv1,
update_gru/horiz_convz, mask_conv2, ...), conv kernels are HWIO, so
utils/from_jax.py bridges JAX's parameters by a rename; the frozen
BatchNorm's statistics are the buffers running_mean / running_var.
`dtype=torch.bfloat16` computes the convolutions in bf16 and keeps JAX's
float32 pins: the encoders' outputs, the correlation, the hidden state,
the flow head's and the mask head's last convs (which take no dtype).
"""

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.encoder_resnet import GroupNorm
from ..ops.grid_sample import grid_sample_bilinear
from ..utils.device import resolve_device

NUM_LEVELS = 4
RADIUS = 4


class Conv(nn.Module):
    """Flax nn.Conv in NHWC with an HWIO kernel and a bias: it computes in
    `dtype`, or where that is None in the promotion of the input's and the
    kernel's dtypes (Flax's rule)."""

    def __init__(self, cin: int, cout: int, ksize: Tuple[int, int], stride: int = 1,
                 padding: Tuple[int, int] = (0, 0), dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(*ksize, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def init_weights(self, g):
        # the scale of Flax's default lecun_normal, untruncated
        fan_in = self.weight.shape[0] * self.weight.shape[1] * self.weight.shape[2]
        with torch.no_grad():
            self.weight.copy_(torch.randn(self.weight.shape, generator=g) / math.sqrt(fan_in))
            self.bias.zero_()

    def forward(self, x):
        dt = self.dtype if self.dtype is not None else torch.promote_types(x.dtype,
                                                                           self.weight.dtype)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt).permute(3, 2, 0, 1),
                     self.bias.to(dt), stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1)


class FrozenBatchNorm(nn.Module):
    """Eval-mode BatchNorm with checkpoint statistics (the official context
    encoder's BatchNorm2d, frozen): x * w + b with w = scale * rsqrt(var +
    eps), b = bias - mean * w, computed in the parameters' dtype and cast
    to x's."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.eps = eps

    def forward(self, x):
        w = self.weight * torch.rsqrt(self.running_var + self.eps)
        b = self.bias - self.running_mean * w
        return x * w.to(x.dtype) + b.to(x.dtype)


def _norm(norm_type: str, c: int) -> nn.Module:
    if norm_type == "batch":
        return FrozenBatchNorm(c)
    # instance norm without affine, eps 1e-5 (torch InstanceNorm2d's; Flax
    # GroupNorm(group_size=1, epsilon=1e-5) in JAX)
    return GroupNorm(c, c, affine=False, eps=1e-5)


class ResBlock(nn.Module):
    def __init__(self, cin: int, ch: int, stride: int, norm_type: str,
                 dtype: Optional[torch.dtype]):
        super().__init__()
        self.conv1 = Conv(cin, ch, (3, 3), stride, (1, 1), dtype)
        self.norm1 = _norm(norm_type, ch)
        self.conv2 = Conv(ch, ch, (3, 3), 1, (1, 1), dtype)
        self.norm2 = _norm(norm_type, ch)
        self.project = stride != 1 or cin != ch
        if self.project:
            self.downsample = Conv(cin, ch, (1, 1), stride, (0, 0), dtype)
            self.norm3 = _norm(norm_type, ch)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.project:
            x = self.norm3(self.downsample(x))
        return F.relu(x + y)


class Encoder(nn.Module):
    """fnet / cnet trunk: 1/8 resolution, `out_ch` channels; norm_type
    "instance" (fnet) or "batch" (cnet, frozen)."""

    def __init__(self, out_ch: int = 256, norm_type: str = "instance",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv(3, 64, (7, 7), 2, (3, 3), dtype)
        self.norm1 = _norm(norm_type, 64)
        cin = 64
        for i, (ch, stride) in enumerate(((64, 1), (96, 2), (128, 2))):
            self.add_module(f"layer{i + 1}_0", ResBlock(cin, ch, stride, norm_type, dtype))
            self.add_module(f"layer{i + 1}_1", ResBlock(ch, ch, 1, norm_type, dtype))
            cin = ch
        self.conv2 = Conv(128, out_ch, (1, 1), 1, (0, 0), dtype)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        for i in range(3):
            x = getattr(self, f"layer{i + 1}_1")(getattr(self, f"layer{i + 1}_0")(x))
        return self.conv2(x)


def corr_pyramid(f1: torch.Tensor, f2: torch.Tensor) -> list:
    """All-pairs correlation over sqrt(C) and its 2x2 average-pooled levels
    (floor: an odd edge row or column is dropped, a level below 2 texels a
    side is empty). f1, f2 [N, H, W, C] -> NUM_LEVELS maps [N*H*W, h_l, w_l, 1]."""
    n, h, w, c = f1.shape
    corr = torch.matmul(f1.reshape(n, h * w, c), f2.reshape(n, h * w, c).transpose(1, 2))
    corr = (corr / math.sqrt(c)).reshape(n * h * w, h, w, 1)
    pyramid = [corr]
    for _ in range(NUM_LEVELS - 1):
        b, ch, cw, _ = corr.shape
        corr = corr[:, :ch // 2 * 2, :cw // 2 * 2]
        corr = corr.reshape(b, ch // 2, 2, cw // 2, 2, 1).sum(dim=(2, 4)) / 4.0
        pyramid.append(corr)
    return pyramid


def corr_lookup(pyramid: list, coords: torch.Tensor) -> torch.Tensor:
    """Radius-4 bilinear lookups at every level, zeros outside the map.
    coords [N, H, W, 2] (x, y) at 1/8 resolution -> [N, H, W, 4 * 81]."""
    n, h, w, _ = coords.shape
    r = RADIUS
    # the official channel order: offsets stack(meshgrid(di, dj, "ij"))
    # added to (x, y), so the x offset varies slowest
    steps = torch.arange(-r, r + 1.0, dtype=coords.dtype, device=coords.device)
    d = torch.stack(torch.meshgrid(steps, steps, indexing="ij"), -1).reshape(-1, 2)
    out = []
    for lvl, corr in enumerate(pyramid):
        ch, cw = corr.shape[1:3]
        pts = coords.reshape(n * h * w, 1, 2) / (2.0 ** lvl) + d[None]
        # to [-1, 1] (grid_sample's align_corners=True convention)
        gx = pts[..., 0] / max(cw - 1, 1) * 2.0 - 1.0
        gy = pts[..., 1] / max(ch - 1, 1) * 2.0 - 1.0
        sampled = grid_sample_bilinear(corr, torch.stack([gx, gy], -1), padding_mode="zeros")
        out.append(sampled.reshape(n, h, w, -1))
    return torch.cat(out, dim=-1)


class MotionEncoder(nn.Module):
    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        corr_ch = NUM_LEVELS * (2 * RADIUS + 1) ** 2
        self.convc1 = Conv(corr_ch, 256, (1, 1), 1, (0, 0), dtype)
        self.convc2 = Conv(256, 192, (3, 3), 1, (1, 1), dtype)
        self.convf1 = Conv(2, 128, (7, 7), 1, (3, 3), dtype)
        self.convf2 = Conv(128, 64, (3, 3), 1, (1, 1), dtype)
        self.conv = Conv(256, 126, (3, 3), 1, (1, 1), dtype)

    def forward(self, flow, corr):
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        cf = F.relu(self.conv(torch.cat([c, f], -1)))
        # torch.cat promotes as jnp.concatenate does (bf16 + float32 -> float32)
        return torch.cat([cf, flow], dim=-1)  # 128


class SepConvGRU(nn.Module):
    def __init__(self, hidden: int = 128, input_dim: int = 256,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        for name, ks, pad in (("horiz", (1, 5), (0, 2)), ("vert", (5, 1), (2, 0))):
            for gate in ("convz", "convr", "convq"):
                self.add_module(f"{name}_{gate}",
                                Conv(hidden + input_dim, hidden, ks, 1, pad, dtype))

    def _gru(self, h, x, name):
        hx = torch.cat([h, x], dim=-1)
        z = torch.sigmoid(getattr(self, f"{name}_convz")(hx))
        r = torch.sigmoid(getattr(self, f"{name}_convr")(hx))
        q = torch.tanh(getattr(self, f"{name}_convq")(torch.cat([r * h, x], dim=-1)))
        return (1 - z) * h + z * q

    def forward(self, h, x):
        return self._gru(self._gru(h, x, "horiz"), x, "vert")


class FlowHead(nn.Module):
    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv(128, 256, (3, 3), 1, (1, 1), dtype)
        self.conv2 = Conv(256, 2, (3, 3), 1, (1, 1))  # no dtype, as in JAX

    def forward(self, h):
        return self.conv2(F.relu(self.conv1(h)))


class RAFT(nn.Module):
    """forward(image1, image2 [N, H, W, 3] in [0, 1]) -> flow [N, H, W, 2]
    in pixels; H and W multiples of 8 (InputPadder pads them). The weights
    are zero until `init_weights` or `load_torch_raft_state_dict`. It is
    placed on the card, or on `device` where the caller names one, and
    raises where there is no card and no device is named."""

    def __init__(self, num_iters: int = 20, dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.num_iters, self.dtype = num_iters, dtype
        self.fnet = Encoder(256, "instance", dtype)
        self.cnet = Encoder(256, "batch", dtype)
        self.update_motion = MotionEncoder(dtype)
        self.update_gru = SepConvGRU(128, 256, dtype)
        self.update_flow_head = FlowHead(dtype)
        # the convex upsampling mask head (official: 256 -> 64 * 9)
        self.mask_conv1 = Conv(128, 256, (3, 3), 1, (1, 1), dtype)
        self.mask_conv2 = Conv(256, 64 * 9, (1, 1), 1, (0, 0))  # no dtype, as in JAX
        self.to(resolve_device(device, "RAFT"))

    def init_weights(self, generator: torch.Generator) -> "RAFT":
        """Seeded convolution kernels (N(0, 1 / fan_in)), zero biases,
        identity frozen BatchNorms."""
        for m in self.modules():
            if isinstance(m, Conv):
                m.init_weights(generator)
        return self

    def _pin(self, t):
        # float32 accumulators under a reduced compute dtype
        return t.float() if self.dtype is not None else t

    def forward(self, image1: torch.Tensor, image2: torch.Tensor,
                return_low_res: bool = False) -> torch.Tensor:
        x1, x2 = image1 * 2.0 - 1.0, image2 * 2.0 - 1.0  # official RAFT's [-1, 1]
        if self.dtype is not None:
            x1, x2 = x1.to(self.dtype), x2.to(self.dtype)
        f1, f2 = self._pin(self.fnet(x1)), self._pin(self.fnet(x2))
        pyramid = corr_pyramid(f1, f2)
        cmap = self.cnet(x1)
        hidden = self._pin(torch.tanh(cmap[..., :128]))
        context = self._pin(F.relu(cmap[..., 128:]))

        n, h, w, _ = f1.shape
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=f1.device),
                                torch.arange(w, dtype=torch.float32, device=f1.device),
                                indexing="ij")
        coords0 = torch.stack([xs, ys], -1)[None].expand(n, h, w, 2)
        coords = coords0
        for _ in range(self.num_iters):
            coords = coords.detach()  # the official detach per iteration
            corr = corr_lookup(pyramid, coords)
            flow = coords - coords0
            motion = self.update_motion(flow, corr)
            hidden = self.update_gru(hidden, torch.cat([context, motion], dim=-1))
            coords = coords + self.update_flow_head(hidden)

        flow_low = coords - coords0  # [N, h, w, 2]
        if return_low_res:
            return flow_low
        # convex upsampling (official upsample_flow, with the 0.25 mask
        # scale of its update block: it sets the softmax's temperature)
        mask = 0.25 * self.mask_conv2(F.relu(self.mask_conv1(hidden)))
        mask = torch.softmax(mask.reshape(n, h, w, 9, 64), dim=-2)
        fl = F.pad(flow_low * 8.0, (0, 0, 1, 1, 1, 1))
        neighbors = torch.stack([fl[:, dy:dy + h, dx:dx + w]
                                 for dy in range(3) for dx in range(3)], dim=-2)
        up = torch.einsum("nhwkp,nhwkc->nhwpc", mask.to(neighbors.dtype), neighbors)
        up = up.reshape(n, h, w, 8, 8, 2).permute(0, 1, 3, 2, 4, 5)
        return up.reshape(n, h * 8, w * 8, 2)


class InputPadder:
    """Pad images to a multiple of 8 by edge replication, split evenly
    (raft_wrapper/raft.py:51-74); `unpad` crops a flow back."""

    def __init__(self, shape: Tuple[int, ...]):
        h, w = shape[-3:-1]
        pad_h, pad_w = (-h) % 8, (-w) % 8
        self._pad = (pad_h // 2, pad_h - pad_h // 2, pad_w // 2, pad_w - pad_w // 2)
        self._hw = (h, w)

    def pad(self, *images):
        t, b, l, r = self._pad
        h, w = self._hw
        out = []
        for im in images:
            rows = torch.arange(-t, h + b, device=im.device).clamp(0, h - 1)
            cols = torch.arange(-l, w + r, device=im.device).clamp(0, w - 1)
            out.append(im[:, rows][:, :, cols])
        return out if len(out) > 1 else out[0]

    def unpad(self, flow):
        t, _, l, _ = self._pad
        h, w = self._hw
        return flow[:, t:t + h, l:l + w]


@torch.no_grad()
def compute_video_flow(raft: RAFT, video: torch.Tensor, chunk: int = 8,
                       backward: bool = False) -> torch.Tensor:
    """Chunked video flow (raft_wrapper/raft.py:96-137): video [T, H, W, 3]
    in [0, 1] (on any device; each chunk is copied to RAFT's) -> [T-1, H,
    W, 2] forward flow, frame t to t+1 (or backward, t+1 to t), on RAFT's
    device. Eager: each chunk runs the module's kernels one by one."""
    dev = raft.mask_conv2.weight.device
    src = video[1:] if backward else video[:-1]
    dst = video[:-1] if backward else video[1:]
    padder = InputPadder(src.shape)
    outs = []
    for i in range(0, len(src), chunk):
        a, b = padder.pad(src[i:i + chunk].to(dev), dst[i:i + chunk].to(dev))
        outs.append(padder.unpad(raft(a, b)))
    return torch.cat(outs, dim=0)


def _resize(x: torch.Tensor, target_hw: Tuple[int, int]) -> torch.Tensor:
    # jax.image.resize(method="bilinear"): half-pixel centres, antialiased
    # when it downscales (antialias=True changes nothing when it upscales)
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(target_hw), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def resize_batched_flow(flow: torch.Tensor, target_hw: Tuple[int, int]) -> torch.Tensor:
    """Resize flow maps [B, H, W, 2], rescaling the vectors with the
    resolution (raft_wrapper/raft.py:32-48)."""
    _, h, w, _ = flow.shape
    th, tw = target_hw
    scale = torch.tensor([tw / w, th / h], dtype=flow.dtype, device=flow.device)
    return _resize(flow, target_hw) * scale


def resize_batched_frames(frames: torch.Tensor, target_hw: Tuple[int, int]) -> torch.Tensor:
    """Resize frames [B, H, W, C] (raft_wrapper/raft.py:13-29)."""
    return _resize(frames, target_hw)


def _translate_torchvision_raft_names(state_dict) -> dict:
    """torchvision `raft_large` state_dict names -> princeton-vl's (the two
    are weight-identical; a pure rename)."""
    renames = {}

    def enc(tv, pv):
        renames[f"{tv}.convnormrelu.0"] = f"{pv}.conv1"
        renames[f"{tv}.convnormrelu.1"] = f"{pv}.norm1"
        renames[f"{tv}.conv"] = f"{pv}.conv2"
        for li in (1, 2, 3):
            for bi in (0, 1):
                b_tv = f"{tv}.layer{li}.{bi}"
                b_pv = f"{pv}.layer{li}.{bi}"
                renames[f"{b_tv}.convnormrelu1.0"] = f"{b_pv}.conv1"
                renames[f"{b_tv}.convnormrelu1.1"] = f"{b_pv}.norm1"
                renames[f"{b_tv}.convnormrelu2.0"] = f"{b_pv}.conv2"
                renames[f"{b_tv}.convnormrelu2.1"] = f"{b_pv}.norm2"
                renames[f"{b_tv}.downsample.0"] = f"{b_pv}.downsample.0"
                renames[f"{b_tv}.downsample.1"] = f"{b_pv}.norm3"

    enc("feature_encoder", "fnet")
    enc("context_encoder", "cnet")
    me = "update_block.motion_encoder"
    for tv, pv in (("convcorr1", "convc1"), ("convcorr2", "convc2"),
                   ("convflow1", "convf1"), ("convflow2", "convf2"), ("conv", "conv")):
        renames[f"{me}.{tv}.0"] = f"update_block.encoder.{pv}"
    for idx in ("1", "2"):
        for gate in ("convz", "convr", "convq"):
            renames[f"update_block.recurrent_block.convgru{idx}.{gate}"] = \
                f"update_block.gru.{gate}{idx}"
    renames["update_block.flow_head.conv1"] = "update_block.flow_head.conv1"
    renames["update_block.flow_head.conv2"] = "update_block.flow_head.conv2"
    renames["mask_predictor.convrelu.0"] = "update_block.mask.0"
    renames["mask_predictor.conv"] = "update_block.mask.2"

    out = {}
    for k, v in state_dict.items():
        base = k[len("module."):] if k.startswith("module.") else k
        stem, _, leaf = base.rpartition(".")
        new = renames.get(stem)
        out[f"{new}.{leaf}" if new is not None else base] = v
    return out


def load_torch_raft_state_dict(raft: RAFT, state_dict, unused_out: list = None
                               ) -> Dict[str, torch.Tensor]:
    """Load an official princeton-vl RAFT checkpoint (raft-things.pth etc.,
    'module.'-prefixed) or a torchvision `raft_large` state_dict (its names
    detected and translated) into `raft`, in place; entries the checkpoint
    lacks (fnet's instance norms have none) keep the module's. Returns the
    ported entries (the module's names and layouts: conv kernels HWIO).
    Checkpoint tensors left over (num_batches_tracked counters aside) are
    appended to `unused_out`, or printed where it is None: a non-empty set
    means the port is incomplete for that checkpoint."""
    if any(k.split("module.")[-1].startswith(("feature_encoder.", "context_encoder."))
           for k in state_dict):
        state_dict = _translate_torchvision_raft_names(state_dict)
    ported, used = {}, set()

    def t(name):
        key = name if name in state_dict else f"module.{name}"
        used.add(key)
        v = state_dict[key]
        return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)

    def has(name):
        return name in state_dict or f"module.{name}" in state_dict

    def conv(dst, src):
        ported[f"{dst}.weight"] = t(f"{src}.weight").transpose(2, 3, 1, 0)
        if has(f"{src}.bias"):
            ported[f"{dst}.bias"] = t(f"{src}.bias")

    def frozen_bn(dst, src):
        if not has(f"{src}.running_mean"):
            return  # the instance-norm side (fnet): no tensors
        ported[f"{dst}.weight"] = t(f"{src}.weight")
        ported[f"{dst}.bias"] = t(f"{src}.bias")
        ported[f"{dst}.running_mean"] = t(f"{src}.running_mean")
        ported[f"{dst}.running_var"] = t(f"{src}.running_var")

    for net in ("fnet", "cnet"):
        conv(f"{net}.conv1", f"{net}.conv1")
        frozen_bn(f"{net}.norm1", f"{net}.norm1")
        conv(f"{net}.conv2", f"{net}.conv2")
        for li in (1, 2, 3):
            for bi in range(2):
                base = f"{net}.layer{li}.{bi}"
                dst = f"{net}.layer{li}_{bi}"
                conv(f"{dst}.conv1", f"{base}.conv1")
                conv(f"{dst}.conv2", f"{base}.conv2")
                frozen_bn(f"{dst}.norm1", f"{base}.norm1")
                frozen_bn(f"{dst}.norm2", f"{base}.norm2")
                if any(k.startswith((f"{base}.downsample", f"module.{base}.downsample"))
                       for k in state_dict):
                    conv(f"{dst}.downsample", f"{base}.downsample.0")
                    # norm3 is registered both as .norm3 and .downsample.1
                    frozen_bn(f"{dst}.norm3", f"{base}.norm3")
                    for alias in (f"{base}.downsample.1", f"module.{base}.downsample.1"):
                        used.update(k for k in state_dict if k.startswith(alias))

    me = "update_block.encoder"
    for name in ("convc1", "convc2", "convf1", "convf2", "conv"):
        conv(f"update_motion.{name}", f"{me}.{name}")
    for direction, idx in (("horiz", "1"), ("vert", "2")):
        for gate in ("convz", "convr", "convq"):
            conv(f"update_gru.{direction}_{gate}", f"update_block.gru.{gate}{idx}")
    conv("update_flow_head.conv1", "update_block.flow_head.conv1")
    conv("update_flow_head.conv2", "update_block.flow_head.conv2")
    conv("mask_conv1", "update_block.mask.0")
    conv("mask_conv2", "update_block.mask.2")

    ported = {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
              for k, v in ported.items()}
    state = raft.state_dict()
    unknown = sorted(set(ported) - set(state))
    if unknown:
        raise KeyError(f"ported entries the module lacks: {unknown[:5]}")
    state.update(ported)
    raft.load_state_dict(state, strict=True)

    leftovers = sorted(k for k in state_dict
                       if k not in used and not k.endswith("num_batches_tracked"))
    if unused_out is not None:
        unused_out.extend(leftovers)
    elif leftovers:
        print(f"load_torch_raft_state_dict: {len(leftovers)} unported checkpoint "
              f"tensors: {leftovers[:8]}{'...' if len(leftovers) > 8 else ''}")
    return ported
