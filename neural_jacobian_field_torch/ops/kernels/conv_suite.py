"""K9: the encoder's convolutions — the stride-1 3x3 CUDA kernels, their
plain versions, and the plain stride-2 / 1x1 partners.

Replaces neural_jacobian_field_tpu/ops/pallas/conv_suite.py. The stride-1
3x3 conv is the `_conv_s1` custom_vjp there and `conv_s1` here, a
torch.autograd.Function over three kernel wrappers:
  - K9-fwd (`conv3x3_s1`, TPU `_s1_fwd`): the hand-written implicit GEMM in
    csrc/conv3x3_s1.cu (TMA-fed wgmma);
  - K9-dgrad (`conv3x3_s1_dgrad`): the SAME kernel on the cotangent and the
    rotated, transposed weights (a stride-1 same-pad conv's input gradient is
    itself such a conv), which it reads from the forward's w itself, counted
    under its own name;
  - K9-wgrad (`conv3x3_s1_wgrad`, TPU `_s1_wgrad`): csrc/conv3x3_wgrad.cu,
    float32 dW [3, 3, C, Cout], cast to w's dtype by the Function.
K10 (`conv3x3_s1_stats`, TPU `_s1_fwd_stats`) is K9-fwd's kernel with a
stats epilogue: it also returns the per-channel sum and sum of squares of
the output over (B, H, W), from the float32 accumulator, for training-mode
BatchNorm (conv_impl="pallas_fused"). `ConvS1Stats` is the JAX
`_conv_s1_stats`: its backward folds the two statistics' cotangents into one
output cotangent and hands it to K9-dgrad and K9-wgrad.
The kernels' headers say what bounds them. The weights go to the kernels as
the HWIO tensor, no copy. `conv_plan` and `wgrad_plan` choose each shape's
tiles, grid and pixel slices; shapes with C or Cout not a multiple of 8
(which TMA cannot take) go to a legacy WMMA kernel, counted apart in each
wrapper's `legacy_launches`. The kernels take every stride-1 shape;
`conv3x3_supported`'s row-block gate is a TPU tiling limit and is not
carried over. The stride-2 3x3 and the 1x1 projections were plain XLA in JAX
and stay plain PyTorch convolutions here.

All functions take and return NHWC; conv kernels are HWIO.

Dispatch is by device: a CUDA tensor launches the kernel (or raises; the
kernels take bf16), a CPU tensor takes the plain version. The Function looks
its wrappers up in this module at call time, so swapping a wrapper for its
plain version here swaps it for the forward and the backward alike.
"""

import contextlib
import functools
from typing import NamedTuple

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


# Streaming multiprocessors of an H100 SXM: the default of the plans; the
# wrappers pass the card's own count.
SMS = 132


class ConvPlan(NamedTuple):
    """How K9-fwd, K9-dgrad and K10 run one shape. bn 0: the legacy kernel
    (C or Cout not a multiple of 8), 64-pixel row blocks. Otherwise (bn 64)
    the TMA kernel: each block a th x tw patch of output pixels (th * tw =
    128, or 64 where that gives too few blocks; tw 8 or 16) and 64 output
    channels, over the K steps of `k_steps(C)`."""
    th: int
    tw: int
    bn: int
    tiles_y: int
    tiles_x: int
    m_tiles: int  # row blocks, in (b, ty, tx) order: K10's partial rows
    n_tiles: int

    @property
    def legacy(self) -> bool:
        return self.bn == 0


class WgradPlan(NamedTuple):
    """How K9-wgrad runs one shape. nh 0: the legacy kernel, the B*H*W rows
    cut into `splits` slices of `per` rows. Otherwise the TMA kernel: dW in
    k_tiles = 3 tap columns x ceil(C / 64) chunks by n_tiles of 64 nh output
    channels, the p_tiles th x tw patches (th * tw = 64, tw 8, 16 or 32)
    cut into `splits` slices of `per` patches, each slice one float32
    partial, the partials added in slice order."""
    th: int
    tw: int
    nh: int
    tiles_y: int
    tiles_x: int
    p_tiles: int
    k_tiles: int
    n_tiles: int
    splits: int
    per: int

    @property
    def legacy(self) -> bool:
        return self.nh == 0

    def slices(self):
        """[begin, end) of each slice, in the order the partials are added."""
        return [(s * self.per, min(self.p_tiles, (s + 1) * self.per)) for s in range(self.splits)]


def k_steps(c: int):
    """The TMA forward kernel's K loop, in order: (tap, first channel), tap =
    dy * 3 + dx: per 64-channel chunk of C, per tap column dx (one ring
    stage, one halo'd box of x), the three taps dy."""
    return [(dy * 3 + dx, c0) for c0 in range(0, c, 64) for dx in range(3) for dy in range(3)]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _patch(h: int, w: int, rows: int, widths=None):
    """The th x tw patch of `rows` pixels (powers of two, each at most 256;
    tw in `widths` where given) that covers an h x w image with the fewest
    pixels, then the squarest."""
    best = None
    th = 1
    while th <= rows:
        tw = rows // th
        if th <= 256 and tw <= 256 and (widths is None or tw in widths):
            area = _cdiv(h, th) * th * _cdiv(w, tw) * tw
            key = (area, abs(th.bit_length() - tw.bit_length()), th)
            best = min(best or (key, th, tw), (key, th, tw))
        th *= 2
    return best[1], best[2]


# patch widths of the TMA kernels: a multiple of 8 rows per patch row (the
# shifted halo tiles stay 1,024-byte aligned); the forward kernel is built
# for 8 and 16, the wgrad kernel takes up to 32
_FWD_WIDTHS, _WGRAD_WIDTHS = (8, 16), (8, 16, 32)


@functools.lru_cache(maxsize=256)
def conv_plan(b: int, h: int, w: int, c: int, cout: int, sms: int = SMS,
              patch: tuple | None = None) -> ConvPlan:
    """The plan of a stride-1 conv of x [b, h, w, c] to cout channels (for
    the dgrad c is the forward's Cout and cout its C): 128-pixel patches
    where they give five blocks per SM (of `sms`) or more, else 64-pixel
    ones (the patch sizes measured fastest at the encoder's shapes on an
    H100). `patch` forces (th, tw) (tests of ragged edges)."""
    if c % 8 or cout % 8:
        return ConvPlan(0, 0, 0, 0, 0, _cdiv(b * h * w, 64), _cdiv(cout, 64))
    if patch is None:
        th, tw = _patch(h, w, 128, _FWD_WIDTHS)
        if b * _cdiv(h, th) * _cdiv(w, tw) * _cdiv(cout, 64) < 5 * sms:
            th, tw = _patch(h, w, 64, _FWD_WIDTHS)
    else:
        th, tw = patch
    ty, tx = _cdiv(h, th), _cdiv(w, tw)
    m_tiles = b * ty * tx
    return ConvPlan(th, tw, 64, ty, tx, m_tiles, _cdiv(cout, 64))


@functools.lru_cache(maxsize=256)
def wgrad_plan(b: int, h: int, w: int, c: int, cout: int, sms: int = SMS,
               patch: tuple | None = None) -> WgradPlan:
    """The plan of K9-wgrad for x [b, h, w, c] and g [b, h, w, cout]: as many
    pixel slices as keep the grid within one wave of `sms` blocks (the
    legacy kernel: about four blocks per SM, slices of at least 256 rows, a
    multiple of its 32). `patch` forces (th, tw)."""
    if c % 8 or cout % 8:
        rows, k_tiles, n_tiles = b * h * w, _cdiv(9 * c, 64), _cdiv(cout, 64)
        splits = max(1, min(_cdiv(rows, 256), _cdiv(4 * sms, k_tiles * n_tiles)))
        per = _cdiv(_cdiv(rows, splits), 32) * 32
        return WgradPlan(0, 0, 0, 0, 0, rows, k_tiles, n_tiles, _cdiv(rows, per), per)
    th, tw = patch or _patch(h, w, 64, _WGRAD_WIDTHS)
    ty, tx = _cdiv(h, th), _cdiv(w, tw)
    p_tiles = b * ty * tx
    nh = 2 if cout > 64 else 1
    k_tiles, n_tiles = 3 * _cdiv(c, 64), _cdiv(cout, 64 * nh)
    per = _cdiv(p_tiles, max(1, min(p_tiles, sms // (k_tiles * n_tiles))))
    return WgradPlan(th, tw, nh, ty, tx, p_tiles, k_tiles, n_tiles, _cdiv(p_tiles, per), per)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _conv_operands(x: torch.Tensor, w: torch.Tensor, name: str, dgrad: bool = False):
    """The stride-1 kernels' operands, checked: x contiguous bf16 NHWC and w
    the bf16 HWIO kernel on x's device, [3, 3, C, Cout] (the dgrad's: the
    forward's [3, 3, Cout, C], which the kernel reads rotated)."""
    if x.dim() != 4 or w.dim() != 4 or w.shape[:2] != (3, 3) \
            or w.shape[3 if dgrad else 2] != x.shape[-1]:
        raise ValueError(f"{name}: x {tuple(x.shape)} / w {tuple(w.shape)}")
    x = x.contiguous()
    check_cuda_tensor(x, f"{name} x", torch.bfloat16, 4)
    w = w.to(device=x.device, dtype=torch.bfloat16).contiguous()
    check_cuda_tensor(w, f"{name} w", torch.bfloat16, 4)
    return x, w


def _on_device(t):
    """t's device as the current one for a launch; nothing to switch (and no
    host time spent) when it already is."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def _count(wrapper, legacy: bool) -> None:
    wrapper.launches += 1
    wrapper.legacy_launches += legacy


def _conv3x3_s1_cuda(x: torch.Tensor, w: torch.Tensor, counter, dgrad: bool = False,
                     plan: ConvPlan | None = None) -> torch.Tensor:
    """Launch K9-fwd's kernel (or, with dgrad, the input gradient from the
    forward's w), counted on `counter` (its wrapper)."""
    x, w = _conv_operands(x, w, "conv3x3_s1", dgrad)
    b, h, wd, c = x.shape
    cout = w.shape[2 if dgrad else 3]
    y = torch.empty((b, h, wd, cout), dtype=torch.bfloat16, device=x.device)
    if y.numel() == 0:
        return y
    plan = plan or conv_plan(b, h, wd, c, cout, _sms(x.device.index))
    lib = load_kernels()
    with _on_device(x):
        _count(counter, plan.legacy)
        lib.call("njf_conv3x3_s1_fwd", x.data_ptr(), w.data_ptr(), y.data_ptr(), b, h, wd, c,
                 cout, plan.th, plan.tw, plan.bn, int(dgrad), stream_of(x))
    return y


def _conv3x3_s1_stats_cuda(x: torch.Tensor, w: torch.Tensor, plan: ConvPlan | None = None):
    x, w = _conv_operands(x, w, "conv3x3_s1_stats")
    b, h, wd, c = x.shape
    cout = w.shape[-1]
    y = torch.empty((b, h, wd, cout), dtype=torch.bfloat16, device=x.device)
    if y.numel() == 0:
        return y, *(torch.zeros((cout,), dtype=torch.float32, device=x.device) for _ in range(2))
    s1, s2 = (torch.empty((cout,), dtype=torch.float32, device=x.device) for _ in range(2))
    plan = plan or conv_plan(b, h, wd, c, cout, _sms(x.device.index))
    partial = torch.empty((2, plan.m_tiles, cout), dtype=torch.float32, device=x.device)
    lib = load_kernels()
    with _on_device(x):
        _count(conv3x3_s1_stats, plan.legacy)
        lib.call("njf_conv3x3_s1_fwd_stats", x.data_ptr(), w.data_ptr(), y.data_ptr(),
                 partial.data_ptr(), s1.data_ptr(), s2.data_ptr(), b, h, wd, c, cout, plan.th,
                 plan.tw, plan.bn, plan.m_tiles, stream_of(x))
    return y, s1, s2


def _conv3x3_s1_wgrad_cuda(x: torch.Tensor, g: torch.Tensor,
                           plan: WgradPlan | None = None) -> torch.Tensor:
    if x.dim() != 4 or g.dim() != 4 or x.shape[:3] != g.shape[:3]:
        raise ValueError(f"conv3x3_s1_wgrad: x {tuple(x.shape)} / g {tuple(g.shape)}")
    x, g = x.contiguous(), g.contiguous()
    check_cuda_tensor(x, "conv3x3_s1_wgrad x", torch.bfloat16, 4)
    check_cuda_tensor(g, "conv3x3_s1_wgrad g", torch.bfloat16, 4)
    b, h, wd, c = x.shape
    cout = g.shape[-1]
    dw = torch.empty((9 * c, cout), dtype=torch.float32, device=x.device)
    if b * h * wd == 0 or dw.numel() == 0:
        return dw.zero_().reshape(3, 3, c, cout)
    plan = plan or wgrad_plan(b, h, wd, c, cout, _sms(x.device.index))
    partial = torch.empty((plan.splits, 9 * c, cout), dtype=torch.float32, device=x.device)
    lib = load_kernels()
    with _on_device(x):
        _count(conv3x3_s1_wgrad, plan.legacy)
        lib.call("njf_conv3x3_s1_wgrad", x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                 dw.data_ptr(), b, h, wd, c, cout, plan.th, plan.tw, plan.nh, plan.splits,
                 plan.per, stream_of(x))
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
                    lambda: _conv3x3_s1_cuda(g, w, conv3x3_s1_dgrad, dgrad=True),
                    lambda: conv3x3_s1_dgrad_plain(g, w))


def conv3x3_s1_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K9-wgrad wrapper: float32 dW [3, 3, C, Cout]."""
    return dispatch("conv3x3_s1_wgrad", x, lambda: _conv3x3_s1_wgrad_cuda(x, g),
                    lambda: conv3x3_s1_wgrad_plain(x, g))


# launches, and among them those of the legacy kernels (C or Cout not a
# multiple of 8), which no main-path shape should reach
for _wrapper in (conv3x3_s1, conv3x3_s1_stats, conv3x3_s1_dgrad, conv3x3_s1_wgrad):
    _wrapper.launches = 0
    _wrapper.legacy_launches = 0
del _wrapper


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
