"""Classic UNet, NHWC in and out (PyTorch counterpart of jacobian2d/unet.py).

`depth` DownConv stages (2x conv3x3 + ReLU, then a 2x2 max-pool but on the
last), mirrored UpConv stages (a 2x2 / 2 transpose-conv upsample, concat
with the skip, 2x conv3x3 + ReLU), a 1x1 output conv; channels double per
depth from `start_filts`. The modules carry Flax's names (down_<i>/conv1,
up_<i>/upconv, conv_final), so `utils/from_jax.from_jax_params_2d` bridges
a JAX param tree leaf by leaf. The layers are PyTorch's (OIHW kernels) on
NHWC activations (channels-last NCHW views), so cuDNN takes them as they
are.

Flax's ConvTranspose (transpose_kernel=False, padding "SAME") slides its
kernel unflipped over the stride-dilated input: y[2i + d] = x[i] K[1 - d].
PyTorch's ConvTranspose2d is the adjoint of a conv: y[2i + d] = x[i] W[d].
So W is K flipped in both spatial axes (the bridge does it); with stride 2
and a 2x2 kernel neither pads. The pool's windows do not overlap, and its
CUDA backward gathers: a train step repeats bit for bit.
"""

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models import initializers as init


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, C] (NHWC) -> flax's nn.max_pool(x, (2, 2), strides=(2,
    2)): each window's first maximum gets its gradient."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, stride=2).permute(0, 2, 3, 1).contiguous()


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class Conv(nn.Conv2d):
    """nn.Conv2d on NHWC tensors, computing in the input's dtype (Flax's
    `dtype=`: kernel and bias cast to it)."""

    def forward(self, x):
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return _nhwc(self._conv_forward(_nchw(x), w, b))


class ConvTranspose(nn.ConvTranspose2d):
    """nn.ConvTranspose2d (kernel 2, stride 2) on NHWC tensors, in the
    input's dtype."""

    def forward(self, x):
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = torch.nn.functional.conv_transpose2d(_nchw(x), w, b, stride=self.stride)
        return _nhwc(y)


def _kaiming_in_(conv: nn.Module, g) -> None:
    """variance_scaling(2, fan_in, normal) on the kernel as Flax lays it out
    (fan_in = kh kw in), zeros for the bias."""
    w = conv.weight
    cin = w.shape[0] if isinstance(conv, nn.ConvTranspose2d) else w.shape[1]
    fan_in = cin * w.shape[2] * w.shape[3]
    init.normal_(w, (2.0 / fan_in) ** 0.5, g)
    init.zeros_(conv.bias)


class DownConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, pooling: bool = True):
        super().__init__()
        self.pooling = pooling
        self.conv1 = Conv(in_channels, out_channels, 3, padding=1)
        self.conv2 = Conv(out_channels, out_channels, 3, padding=1)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.relu(self.conv1(x))
        x = torch.relu(self.conv2(x))
        before_pool = x
        if self.pooling:
            x = max_pool_2x2(x)
        return x, before_pool


class UpConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.upconv = ConvTranspose(in_channels, out_channels, 2, stride=2)
        self.conv1 = Conv(2 * out_channels, out_channels, 3, padding=1)
        self.conv2 = Conv(out_channels, out_channels, 3, padding=1)

    def forward(self, from_down, from_up):
        up = self.upconv(from_up)
        x = torch.cat([up, from_down], dim=-1)  # merge_mode="concat"
        x = torch.relu(self.conv1(x))
        return torch.relu(self.conv2(x))


class UNet(nn.Module):
    """forward([B, H, W, in_channels]) -> [B, H, W, out_channels] float32.
    H, W must be divisible by 2**(depth - 1)."""

    def __init__(self, in_channels: int, out_channels: int, depth: int = 3,
                 start_filts: int = 32, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.depth, self.compute_dtype = depth, compute_dtype
        cin = in_channels
        for i in range(depth):
            cout = start_filts * 2 ** i
            self.add_module(f"down_{i}", DownConv(cin, cout, pooling=i < depth - 1))
            cin = cout
        for i in range(depth - 2, -1, -1):
            self.add_module(f"up_{i}", UpConv(start_filts * 2 ** (i + 1), start_filts * 2 ** i))
        self.conv_final = Conv(start_filts, out_channels, 1)

    def init_weights(self, g: torch.Generator) -> "UNet":
        """Flax's initialisers: kaiming_normal_in on every 3x3 conv and
        upconv, xavier_normal (glorot, truncated normal) on conv_final, zero
        biases."""
        for name, m in self.named_modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)) and m is not self.conv_final:
                _kaiming_in_(m, g)
        w = self.conv_final.weight
        fan_in, fan_out = w.shape[1] * w.shape[2] * w.shape[3], w.shape[0] * w.shape[2] * w.shape[3]
        init.truncated_normal_(w, (2.0 / (fan_in + fan_out)) ** 0.5, g)
        init.zeros_(self.conv_final.bias)
        return self

    def encode(self, x) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        dt = self.compute_dtype
        x = x.to(dt) if dt is not None else x
        skips = []
        for i in range(self.depth):
            x, before_pool = getattr(self, f"down_{i}")(x)
            skips.append(before_pool)
        return x, skips

    def forward(self, x, return_features: bool = False):
        x, skips = self.encode(x)
        features = x  # the bottleneck (the reference UNet's encoder output)
        for i in range(self.depth - 2, -1, -1):
            x = getattr(self, f"up_{i}")(skips[i], x)
        # conv_final carries no dtype in Flax: it computes in the promotion
        # of its input's and its params' dtypes; the output is float32, as
        # JAX's (in a float64 run too)
        x = self.conv_final(x.to(torch.promote_types(x.dtype, self.conv_final.weight.dtype)))
        x = x.to(torch.float32)
        if return_features:
            return x, features.to(torch.float32)
        return x
