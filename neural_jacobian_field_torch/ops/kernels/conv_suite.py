"""K9: the encoder's convolutions — the stride-1 3x3 CUDA kernels, their
plain versions, and the plain stride-2 / 1x1 partners.

Replaces neural_jacobian_field_tpu/ops/pallas/conv_suite.py. The stride-1
3x3 conv is the `_conv_s1` custom_vjp there and `conv_s1` here, a
torch.autograd.Function over three kernel wrappers:
  - K9-fwd (`conv3x3_s1`, TPU `_s1_fwd`): the hand-written implicit GEMM in
    csrc/conv3x3_s1.cu;
  - K9-dgrad (`conv3x3_s1_dgrad`): the SAME kernel on the cotangent and the
    rotated, transposed weights (a stride-1 same-pad conv's input gradient is
    itself such a conv), counted under its own name;
  - K9-wgrad (`conv3x3_s1_wgrad`, TPU `_s1_wgrad`): csrc/conv3x3_wgrad.cu,
    float32 dW [3, 3, C, Cout], cast to w's dtype by the Function.
K10 (`conv3x3_s1_stats`, TPU `_s1_fwd_stats`) is K9-fwd's kernel with a
stats epilogue: it also returns the per-channel sum and sum of squares of
the output over (B, H, W), from the float32 accumulator, for training-mode
BatchNorm (conv_impl="pallas_fused"). `ConvS1Stats` is the JAX
`_conv_s1_stats`: its backward folds the two statistics' cotangents into one
output cotangent and hands it to K9-dgrad and K9-wgrad.
The kernels' headers say what bounds them. The weights go to K9-fwd as the
[9C, Cout] matrix of the TPU kernel, tap-major (row = (dy*3 + dx)*C + c): an
HWIO kernel reshaped, no copy. The kernels take every stride-1 shape;
`conv3x3_supported`'s row-block gate is a TPU tiling limit and is not
carried over. The stride-2 3x3 and the 1x1 projections were plain XLA in JAX
and stay plain PyTorch convolutions here.

All functions take and return NHWC; conv kernels are HWIO.

Dispatch is by device: a CUDA tensor launches the kernel (or raises; the
kernels take bf16), a CPU tensor takes the plain version. The Function looks
its wrappers up in this module at call time, so swapping a wrapper for its
plain version here swaps it for the forward and the backward alike.
"""

import torch
import torch.nn.functional as F

from .build import check_cuda_tensor, dispatch, load_kernels, stream_of


def _acc_dtype(dtype):
    """Accumulator type: at least float32, float64 for float64 inputs."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _assemble(x: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's assembled operand: the nine taps of x [B, H, W, C]
    side by side, [B, H, W, 9C], tap-major (dy*3 + dx), zero halo."""
    h, wd = x.shape[1:3]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.cat([xp[:, dy:dy + h, dx:dx + wd, :]
                      for dy in range(3) for dx in range(3)], dim=-1)


def _conv_acc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The assembled x times w as [9C, Cout] in x's dtype, accumulated (and
    returned) in at least float32."""
    at = _acc_dtype(x.dtype)
    return _assemble(x).to(at) @ w.reshape(-1, w.shape[-1]).to(x.dtype).to(at)


def conv3x3_s1_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x [B, H, W, C], w [3, 3, C, Cout] -> [B, H, W,
    Cout] in x's dtype, as the TPU kernel computes it: the nine taps assembled
    into [B, H, W, 9C] (tap-major, zero halo) times w as [9C, Cout] in x's
    dtype, accumulated in at least float32."""
    return _conv_acc(x, w).to(x.dtype)


def conv3x3_s1_stats_plain(x: torch.Tensor, w: torch.Tensor):
    """Plain PyTorch version of K10: (y, s1, s2) with y as conv3x3_s1_plain
    computes it and s1, s2 [Cout] the sums over (B, H, W) of the uncast
    product and of its square, in the accumulator's type."""
    acc = _conv_acc(x, w)
    return acc.to(x.dtype), acc.sum(dim=(0, 1, 2)), (acc * acc).sum(dim=(0, 1, 2))


def _rotate(w: torch.Tensor) -> torch.Tensor:
    """The dgrad weights: w flipped in both taps, in and out channels swapped
    ([3, 3, C, Cout] -> [3, 3, Cout, C])."""
    return torch.flip(w, (0, 1)).transpose(2, 3)


def conv3x3_s1_dgrad_plain(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of the input gradient: the stride-1 conv of the
    cotangent g [B, H, W, Cout] with the rotated weights -> [B, H, W, C]."""
    return conv3x3_s1_plain(g, _rotate(w))


def conv3x3_s1_wgrad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of the weight gradient, as the TPU kernel computes it:
    the assembled input [B*H*W, 9C] transposed times g [B*H*W, Cout] in at
    least float32 -> dW [3, 3, C, Cout] in that type."""
    c, cout = x.shape[-1], g.shape[-1]
    at = _acc_dtype(x.dtype)
    dw = _assemble(x).reshape(-1, 9 * c).to(at).t() @ g.reshape(-1, cout).to(at)
    return dw.reshape(3, 3, c, cout)


def _conv_operands(x: torch.Tensor, w: torch.Tensor, name: str):
    """The stride-1 kernels' operands, checked: x contiguous bf16 NHWC and w
    as the bf16 [9C, Cout] matrix on x's device."""
    if x.dim() != 4 or w.shape[:2] != (3, 3) or w.shape[2] != x.shape[-1]:
        raise ValueError(f"{name}: x {tuple(x.shape)} / w {tuple(w.shape)}")
    x = x.contiguous()
    check_cuda_tensor(x, f"{name} x", torch.bfloat16, 4)
    wk = w.reshape(-1, w.shape[-1]).to(device=x.device, dtype=torch.bfloat16).contiguous()
    check_cuda_tensor(wk, f"{name} w", torch.bfloat16, 2)
    return x, wk


def _conv3x3_s1_cuda(x: torch.Tensor, w: torch.Tensor, counter) -> torch.Tensor:
    """Launch K9-fwd's kernel, counted on `counter` (its wrapper)."""
    x, wk = _conv_operands(x, w, "conv3x3_s1")
    b, h, wd, c = x.shape
    cout = wk.shape[-1]
    y = torch.empty((b, h, wd, cout), dtype=torch.bfloat16, device=x.device)
    if y.numel() == 0:
        return y
    lib = load_kernels()
    with torch.cuda.device(x.device):
        counter.launches += 1
        lib.call("njf_conv3x3_s1_fwd", x.data_ptr(), wk.data_ptr(), y.data_ptr(),
                 b, h, wd, c, cout, stream_of(x))
    return y


def _conv3x3_s1_stats_cuda(x: torch.Tensor, w: torch.Tensor):
    x, wk = _conv_operands(x, w, "conv3x3_s1_stats")
    b, h, wd, c = x.shape
    cout = wk.shape[-1]
    y = torch.empty((b, h, wd, cout), dtype=torch.bfloat16, device=x.device)
    s1, s2 = (torch.zeros((cout,), dtype=torch.float32, device=x.device) for _ in range(2))
    if y.numel() == 0:
        return y, s1, s2
    nblk = -(-b * h * wd // 64)  # the kernel's row blocks
    partial = torch.empty((2, nblk, cout), dtype=torch.float32, device=x.device)
    lib = load_kernels()
    with torch.cuda.device(x.device):
        conv3x3_s1_stats.launches += 1
        lib.call("njf_conv3x3_s1_fwd_stats", x.data_ptr(), wk.data_ptr(), y.data_ptr(),
                 partial.data_ptr(), s1.data_ptr(), s2.data_ptr(), b, h, wd, c, cout, nblk,
                 stream_of(x))
    return y, s1, s2


def _wgrad_split(rows: int, tiles: int, device) -> tuple:
    """(splits, rows per split) for K9-wgrad: enough blocks for about four per
    SM, each slice at least 256 rows and a multiple of the kernel's 32."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = max(1, min(-(-rows // 256), -(-4 * sms // tiles)))
    per = -(-rows // splits)
    per = -(-per // 32) * 32
    return -(-rows // per), per


def _conv3x3_s1_wgrad_cuda(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    if x.dim() != 4 or g.dim() != 4 or x.shape[:3] != g.shape[:3]:
        raise ValueError(f"conv3x3_s1_wgrad: x {tuple(x.shape)} / g {tuple(g.shape)}")
    x, g = x.contiguous(), g.contiguous()
    check_cuda_tensor(x, "conv3x3_s1_wgrad x", torch.bfloat16, 4)
    check_cuda_tensor(g, "conv3x3_s1_wgrad g", torch.bfloat16, 4)
    b, h, wd, c = x.shape
    cout = g.shape[-1]
    dw = torch.empty((9 * c, cout), dtype=torch.float32, device=x.device)
    rows = b * h * wd
    if rows == 0 or dw.numel() == 0:
        return dw.zero_().reshape(3, 3, c, cout)
    splits, per = _wgrad_split(rows, -(-9 * c // 64) * -(-cout // 64), x.device)
    partial = torch.empty((splits, 9 * c, cout), dtype=torch.float32, device=x.device)
    lib = load_kernels()
    with torch.cuda.device(x.device):
        conv3x3_s1_wgrad.launches += 1
        lib.call("njf_conv3x3_s1_wgrad", x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                 dw.data_ptr(), b, h, wd, c, cout, splits, per, stream_of(x))
    return dw.reshape(3, 3, c, cout)


def conv3x3_s1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K9-fwd wrapper: stride-1 3x3 same-pad conv, NHWC x, HWIO w."""
    return dispatch("conv3x3_s1", x, lambda: _conv3x3_s1_cuda(x, w, conv3x3_s1),
                    lambda: conv3x3_s1_plain(x, w))


def conv3x3_s1_stats(x: torch.Tensor, w: torch.Tensor):
    """K10 wrapper: (y, s1, s2), the stride-1 3x3 conv and the per-channel
    float32 sum and sum of squares of its output over (B, H, W)."""
    return dispatch("conv3x3_s1_stats", x, lambda: _conv3x3_s1_stats_cuda(x, w),
                    lambda: conv3x3_s1_stats_plain(x, w))


def conv3x3_s1_dgrad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K9-dgrad wrapper: the input gradient, through K9-fwd's kernel."""
    return dispatch("conv3x3_s1_dgrad", g,
                    lambda: _conv3x3_s1_cuda(g, _rotate(w), conv3x3_s1_dgrad),
                    lambda: conv3x3_s1_dgrad_plain(g, w))


def conv3x3_s1_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K9-wgrad wrapper: float32 dW [3, 3, C, Cout]."""
    return dispatch("conv3x3_s1_wgrad", x, lambda: _conv3x3_s1_wgrad_cuda(x, g),
                    lambda: conv3x3_s1_wgrad_plain(x, g))


conv3x3_s1.launches = 0
conv3x3_s1_stats.launches = 0
conv3x3_s1_dgrad.launches = 0
conv3x3_s1_wgrad.launches = 0


class ConvS1(torch.autograd.Function):
    """The differentiable stride-1 3x3 conv (the JAX `_conv_s1`)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3x3_s1(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = conv3x3_s1_dgrad(g, w) if ctx.needs_input_grad[0] else None
        dw = conv3x3_s1_wgrad(x, g).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw


def conv_s1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable stride-1 3x3 same-pad conv: K9-fwd forward, K9-dgrad
    and K9-wgrad backward."""
    return ConvS1.apply(x, w)


class ConvS1Stats(torch.autograd.Function):
    """The differentiable K10 conv (the JAX `_conv_s1_stats`). With s1 =
    sum(y) and s2 = sum(y^2) over (B, H, W), the three cotangents fold into
    one output cotangent g = gy + gs1 + 2 y gs2, in the accumulator's type
    with y the rounded output, cast to y's dtype once; then K9-dgrad and
    K9-wgrad as for `ConvS1`."""

    @staticmethod
    def forward(ctx, x, w):
        y, s1, s2 = conv3x3_s1_stats(x, w)
        ctx.save_for_backward(x, w, y)
        return y, s1, s2

    @staticmethod
    def backward(ctx, gy, gs1, gs2):
        x, w, y = ctx.saved_tensors
        at = _acc_dtype(y.dtype)
        g = (gy.to(at) + gs1.to(at) + 2.0 * y.to(at) * gs2.to(at)).to(y.dtype).contiguous()
        dx = conv3x3_s1_dgrad(g, w) if ctx.needs_input_grad[0] else None
        dw = conv3x3_s1_wgrad(x, g).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw


def conv_s1_stats(x: torch.Tensor, w: torch.Tensor):
    """Differentiable stride-1 3x3 same-pad conv that also returns the
    per-channel sum and sum of squares of its output over (B, H, W): K10
    forward, K9-dgrad and K9-wgrad backward."""
    return ConvS1Stats.apply(x, w)


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """Plain convolution in NHWC/HWIO through PyTorch's own conv (the JAX
    package's XLA conv). The result is contiguous NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()


def conv3x3(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Differentiable 3x3 same-pad conv (NHWC): stride 1 through K9,
    stride 2 plain."""
    if stride == 1:
        return conv_s1(x, w)
    if stride == 2:
        return conv_nhwc(x, w, 2, 1)
    raise ValueError(f"conv3x3: unsupported stride {stride}")


def conv1x1(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """1x1 conv (strided slice + channel contraction). w is [1, 1, C, Cout]
    or [C, Cout]."""
    if w.dim() == 4:
        w = w[0, 0]
    if stride != 1:
        x = x[:, ::stride, ::stride, :]
    at = _acc_dtype(x.dtype)
    return (x.to(at) @ w.to(x.dtype).to(at)).to(x.dtype)
