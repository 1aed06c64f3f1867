"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and nvcc (the CUDA toolkit): they are marked
`cuda` and skip elsewhere. The file imports neither JAX nor the JAX package,
so it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -q

Shapes cover the paths the main-path shapes do not: the scalar gather of K9
and K10 (C or Cout not a multiple of 8), K6's narrow copy units, K7-tz at
every d_hidden / d_out instantiation, and ragged tile edges. Each backward kernel
is held against its plain version, each autograd.Function against plain
autograd, and a CUDA output must carry a grad_fn (a kernel wrapper that cut
the graph would train nothing and raise no error). The serving entry points'
CUDA graphs (inference/programs.py; `-k serving`) are held against eager
execution bit for bit, on new inputs and reloaded weights, and are captured
with CUDA's sync debug mode raising; so are the train steps' graphs
(training/train.py; `-k train_program`), held against eager steps bit for bit
wherever five eager runs agree bit for bit, and within the eager runs' own
spread where a backward op on the path sums with atomics.
"""

import contextlib
import math
import statistics

import pytest
import torch

from neural_jacobian_field_torch.ops import kernels as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.parametrize("shape,cout", [
    ((1, 7, 9, 12), 20),       # scalar path, ragged tiles
    ((2, 5, 33, 64), 72),      # vector path, Cout not a multiple of 64
    ((1, 30, 40, 256), 256),   # layer3
])
def test_k9_kernel_matches_plain(dev, shape, cout):
    """Both round the same float32 sums to bf16 once; summation order differs:
    at most one bf16 rounding step (2^-7 relative) apart."""
    g = _gen(0)
    x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((3, 3, shape[-1], cout), generator=g, device=dev) / math.sqrt(9 * shape[-1])
    n0 = K.conv3x3_s1.launches
    got = K.conv3x3_s1(x, w)
    torch.cuda.synchronize()
    assert K.conv3x3_s1.launches == n0 + 1
    want = K.conv3x3_s1_plain(x, w)
    err = (got.float() - want.float()).abs()
    assert (err <= 2.0 ** -7 * want.float().abs() + 1e-3).all(), err.max()


@pytest.mark.parametrize("shape,dtype", [
    ((1, 3, 5, 24), torch.bfloat16),   # 48-byte texels: 16-byte unit
    ((2, 7, 9, 3), torch.float32),     # 12-byte texels: 4-byte unit
    ((1, 4, 4, 1), torch.bfloat16),    # 2-byte texels
    ((1, 240, 320, 128), torch.bfloat16),
])
def test_k6_kernel_is_bit_exact(dev, shape, dtype):
    x = torch.randn(shape, generator=_gen(1), device=dev).to(dtype)
    n0 = K.pack_2x2_flat.launches
    got = K.pack_2x2_flat(x)
    torch.cuda.synchronize()
    assert K.pack_2x2_flat.launches == n0 + 1
    assert torch.equal(got, K.pack_2x2_flat_plain(x))


@pytest.mark.parametrize("n,s,q", [(10, 16, 9), (64, 48, 49), (64, 255, 256), (2048, 256, 257)])
def test_k5_kernel_matches_plain(dev, n, s, q):
    """1e-4 everywhere but at bin ties: the kernel's CDF is a warp scan, the
    plain version's a sequential cumsum, ~1e-7 apart per step, and the
    interpolation divides that by the bin's pdf (as small as ~4e-5 here). At
    a tie a query may change bin: at most one bin width, for at most 1e-4 of
    the queries. Ray 0 has all-zero weights. The kernel equals its order's
    emulation on the CPU bit for bit, and two calls give identical bits."""
    from test_torch_port_k5_k1bwd_plan import k5_emulate

    from neural_jacobian_field_torch.ops.pdf import pdf_queries

    g = _gen(2)
    bins = torch.sort(torch.rand((n, s + 1), generator=g, device=dev), dim=-1).values
    w = torch.rand((n, s), generator=g, device=dev)
    w[0] = 0.0
    u = pdf_queries((n,), q - 1, stratified=True, generator=g, device=dev)
    n0 = K.fused_sample_pdf.launches
    got = K.fused_sample_pdf(bins, w, u)
    torch.cuda.synchronize()
    assert K.fused_sample_pdf.launches == n0 + 1
    want = K.fused_sample_pdf_plain(bins, w, u)
    err = (got - want).abs()
    assert (err > 1e-4).float().mean() <= 1e-4
    assert err.max() <= torch.diff(bins, dim=-1).max()
    assert torch.equal(got.cpu(), k5_emulate(bins.cpu(), w.cpu(), u.cpu()))
    assert torch.equal(K.fused_sample_pdf(bins, w, u), got)


def _trunk(dev, d_in, dh, n_blocks, combine, d_out, g):
    def lin(din, dout):
        return {"kernel": torch.randn((din, dout), generator=g, device=dev) / math.sqrt(din),
                "bias": 0.1 * torch.randn((dout,), generator=g, device=dev)}

    n_lin_z = min(combine, n_blocks)
    p = {"lin_in": lin(d_in, dh)}
    for i in range(n_lin_z):
        p[f"lin_z_{i}"] = {"bias": lin(8, dh)["bias"]}
    for i in range(n_blocks):
        p[f"blocks_{i}_fc_0"] = lin(dh, dh)
        p[f"blocks_{i}_fc_1"] = lin(dh, dh)
    p["lin_out"] = lin(dh, d_out)
    return p, n_lin_z


@pytest.mark.parametrize("n,dh,n_blocks,combine,d_out", [
    (700, 32, 2, 3, 16),
    (333, 64, 3, 1, 24),
    (65536, 128, 5, 3, 1),
    (65536, 128, 5, 3, 24),
])
def test_k7tz_kernel_matches_plain(dev, n, dh, n_blocks, combine, d_out):
    """Same bf16 operations and casts; only the accumulation order differs,
    which can flip a bf16 rounding that later layers carry: 1e-2 of scale."""
    from neural_jacobian_field_torch.models.resnet_fc import MlpCfg

    g = _gen(3)
    params, n_lin_z = _trunk(dev, 63, dh, n_blocks, combine, d_out, g)
    cfg = MlpCfg(n_blocks=n_blocks, d_hidden=dh, combine_layer=combine)
    tz = torch.randn((n, n_lin_z * dh), generator=g, device=dev).to(torch.bfloat16)
    x = (torch.rand((n, 63), generator=g, device=dev) * 2 - 1).to(torch.bfloat16)
    n0 = K.fused_resnet_fc_tz.launches
    got = K.fused_resnet_fc_tz(params, cfg, tz, x, d_out)
    torch.cuda.synchronize()
    assert K.fused_resnet_fc_tz.launches == n0 + 1
    want = K.fused_resnet_fc_tz_plain(params, cfg, tz, x, d_out)
    assert got.shape == want.shape == (n, d_out)
    assert (got - want).abs().max() <= 1e-2 * want.abs().max()


@pytest.mark.parametrize("shape,cout", [
    ((1, 7, 9, 12), 20),        # scalar path, ragged tiles, a half-empty row block
    ((2, 5, 33, 64), 72),       # vector path, Cout not a multiple of 64
    ((7, 30, 40, 256), 256),    # layer3 at batch 7
    ((7, 120, 160, 64), 64),    # layer1 at batch 7: 2,100 row blocks
])
def test_k10_matches_plain_and_repeats(dev, shape, cout):
    """y bit for bit K9-fwd's (the same kernel and tiles); s1 and s2 float32
    sums of the same products in another order: s2 within 1e-4 of itself,
    s1 within 1e-4 of sqrt(n * s2), which bounds the sum of |y|; two calls
    give identical bits (no atomics)."""
    g = _gen(19)
    x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((3, 3, shape[-1], cout), generator=g, device=dev) / math.sqrt(9 * shape[-1])
    n0 = K.conv3x3_s1_stats.launches
    y, s1, s2 = K.conv3x3_s1_stats(x, w)
    torch.cuda.synchronize()
    assert K.conv3x3_s1_stats.launches == n0 + 1
    assert y.dtype == torch.bfloat16 and s1.dtype == s2.dtype == torch.float32
    assert torch.equal(y, K.conv3x3_s1(x, w))
    _, p1, p2 = K.conv3x3_s1_stats_plain(x, w)
    n = shape[0] * shape[1] * shape[2]
    assert float(((s2 - p2).abs() / p2.clamp_min(1e-30)).max()) <= 1e-4
    assert float(((s1 - p1).abs() / (n * p2).sqrt().clamp_min(1e-30)).max()) <= 1e-4
    y2, s1b, s2b = K.conv3x3_s1_stats(x, w)
    assert torch.equal(y, y2) and torch.equal(s1, s1b) and torch.equal(s2, s2b)


def test_k10_function_matches_plain_autograd(dev):
    """autograd.grad through conv_s1_stats (the fold, then K9-dgrad and
    K9-wgrad) against autograd of the plain version, under cotangents on y,
    s1 and s2: the bounds of the K9 Function (dx 3e-2, dW 1e-2 of scale)."""
    g = _gen(20)
    x = torch.randn((2, 30, 40, 64), generator=g, device=dev).to(torch.bfloat16).requires_grad_()
    w = (torch.randn((3, 3, 64, 64), generator=g, device=dev) / 24.0).requires_grad_()
    cts = (torch.randn((2, 30, 40, 64), generator=g, device=dev).to(torch.bfloat16),
           torch.randn((64,), generator=g, device=dev),
           1e-3 * torch.randn((64,), generator=g, device=dev))
    dx, dw = torch.autograd.grad(K.conv_s1_stats(x, w), (x, w), cts)
    px, pw = torch.autograd.grad(K.conv3x3_s1_stats_plain(x, w), (x, w), cts)
    assert _rel(dx, px) <= 3e-2 and _rel(dw, pw) <= 1e-2


# ----------------------------------------------------------- backward kernels

def _rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("shape,cout", [
    ((1, 7, 9, 12), 20),       # scalar path, ragged tiles
    ((2, 5, 33, 64), 72),      # vector path, Cout not a multiple of 64
    ((7, 30, 40, 256), 256),   # layer3 at batch 7
])
def test_k9_wgrad_matches_plain(dev, shape, cout):
    """Both sum the same bf16 products in float32, in another order (split
    partials vs one GEMM): 1e-4 of the largest |dW|."""
    g = _gen(4)
    x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    gy = torch.randn((*shape[:3], cout), generator=g, device=dev).to(torch.bfloat16)
    n0 = K.conv3x3_s1_wgrad.launches
    got = K.conv3x3_s1_wgrad(x, gy)
    torch.cuda.synchronize()
    assert K.conv3x3_s1_wgrad.launches == n0 + 1
    want = K.conv3x3_s1_wgrad_plain(x, gy)
    assert got.dtype == torch.float32 and got.shape == want.shape == (3, 3, shape[-1], cout)
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("shape,cout", [((1, 7, 9, 12), 20), ((2, 30, 40, 64), 64)])
def test_k9_function_matches_plain_autograd(dev, shape, cout):
    """autograd.grad through conv_s1 (K9-dgrad, K9-wgrad) against autograd of
    the plain forward. dx: the kernel rounds one float32 sum to bf16, plain
    autograd adds the nine taps' bf16 gradients in bf16: 3e-2 of scale. dW:
    one bf16 rounding of the plain gradient apart: 1e-2 of scale."""
    g = _gen(5)
    x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16).requires_grad_()
    w = (torch.randn((3, 3, shape[-1], cout), generator=g, device=dev)
         / math.sqrt(9 * shape[-1])).requires_grad_()
    gy = torch.randn((*shape[:3], cout), generator=g, device=dev).to(torch.bfloat16)
    n0 = (K.conv3x3_s1_dgrad.launches, K.conv3x3_s1_wgrad.launches)
    dx, dw = torch.autograd.grad(K.conv_s1(x, w), (x, w), gy)
    torch.cuda.synchronize()
    assert (K.conv3x3_s1_dgrad.launches, K.conv3x3_s1_wgrad.launches) == (n0[0] + 1, n0[1] + 1)
    px, pw = torch.autograd.grad(K.conv3x3_s1_plain(x, w), (x, w), gy)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    assert _rel(dx, px) <= 3e-2 and _rel(dw, pw) <= 1e-2
    # the dgrad kernel alone, against its plain version: one bf16 rounding
    got = K.conv3x3_s1_dgrad(gy, w)
    want = K.conv3x3_s1_dgrad_plain(gy, w)
    assert ((got.float() - want.float()).abs() <= 2.0 ** -7 * want.float().abs() + 1e-3).all()


@pytest.mark.parametrize("shape,dtype", [
    ((2, 7, 9, 3), torch.float32),     # one channel per thread
    ((1, 3, 5, 24), torch.bfloat16),   # 16-byte vectors
    ((1, 1, 1, 8), torch.bfloat16),    # a single texel: every border case at once
    ((1, 4, 4, 1), torch.bfloat16),
    ((7, 240, 320, 128), torch.bfloat16),  # the fine level at batch 7
])
def test_k6_bwd_is_bit_exact(dev, shape, dtype):
    """The same additions in the same order, rounded to the dtype after each."""
    b, h, w, c = shape
    gp = torch.randn((b, h * w, 4 * c), generator=_gen(6), device=dev).to(dtype)
    n0 = K.pack_2x2_flat_bwd.launches
    got = K.pack_2x2_flat_bwd(gp, h)
    torch.cuda.synchronize()
    assert K.pack_2x2_flat_bwd.launches == n0 + 1
    assert torch.equal(got, K.pack_2x2_flat_bwd_plain(gp, h))


def test_k6_function_matches_plain_autograd(dev):
    """Plain autograd sums the same slot gradients in another order: float32
    rounding, 1e-6 of scale."""
    x = torch.randn((2, 5, 7, 16), generator=_gen(7), device=dev, requires_grad=True)
    gp = torch.randn((2, 35, 64), generator=_gen(8), device=dev)
    (got,) = torch.autograd.grad(K.pack_2x2_flat_train(x), x, gp)
    (want,) = torch.autograd.grad(K.pack_2x2_flat_plain(x), x, gp)
    assert _rel(got, want) <= 1e-6


def _k7_case(dev, n, dh, n_blocks, combine, d_out, seed):
    from neural_jacobian_field_torch.models.resnet_fc import MlpCfg

    g = _gen(seed)
    params, n_lin_z = _trunk(dev, 63, dh, n_blocks, combine, d_out, g)
    cfg = MlpCfg(n_blocks=n_blocks, d_hidden=dh, combine_layer=combine)
    tz = torch.randn((n, n_lin_z * dh), generator=g, device=dev).to(torch.bfloat16)
    x = (torch.rand((n, 63), generator=g, device=dev) * 2 - 1).to(torch.bfloat16)
    gy = torch.randn((n, d_out), generator=g, device=dev)
    return params, cfg, tz, x, gy


@pytest.mark.parametrize("n,dh,n_blocks,combine,d_out", [
    (700, 32, 2, 3, 16),
    (333, 64, 3, 1, 24),
    (1000, 64, 2, 0, 8),       # no latent injection
    (65536, 128, 5, 3, 1),     # the proposal trunk
    (65536, 128, 5, 3, 16),    # the density trunk
    (4099, 128, 5, 3, 24),     # the Jacobian trunk, ragged tile
    (65536, 128, 5, 3, 24),    # the Jacobian trunk, as stage 2 runs it backward
])
def test_k7tz_bwd_matches_plain(dev, n, dh, n_blocks, combine, d_out):
    """Same bf16 operations, float32 dx and dW; only the accumulation order
    differs. Through 5 blocks that can round a recomputed bf16 activation the
    other way, which moves one ReLU mask or operand by a bf16 step (measured
    on an H100: exact to 3e-7 at 2 x 32, and at 5 x 128 dW/db within 1.1e-2
    of scale, 3.2e-3 in l2; dtz within 3e-3 in l2, single elements up to
    0.21 of scale, at most 1e-4 of them). Bounds: every dW/db leaf within
    2e-2 of its scale and 1e-2 in l2; dtz within 1e-2 in l2, and at most 1e-3
    of its elements further than 2e-2 of scale."""
    params, cfg, tz, x, gy = _k7_case(dev, n, dh, n_blocks, combine, d_out, 9)
    n0 = K.fused_resnet_fc_tz_bwd.launches
    grads, dtz = K.fused_resnet_fc_tz_bwd(params, cfg, tz, x, gy, d_out)
    torch.cuda.synchronize()
    assert K.fused_resnet_fc_tz_bwd.launches == n0 + 1
    pgrads, pdtz = K.fused_resnet_fc_tz_bwd_plain(params, cfg, tz, x, gy, d_out)
    assert dtz.dtype == tz.dtype and dtz.shape == tz.shape
    if dtz.numel():
        err = (dtz.float() - pdtz.float()).abs()
        assert float(err.norm() / pdtz.float().norm()) <= 1e-2
        assert float((err > 2e-2 * pdtz.float().abs().max()).float().mean()) <= 1e-3
    for layer, leaves in pgrads.items():
        for leaf, want in leaves.items():
            got = grads[layer][leaf]
            assert got.dtype == torch.float32 and got.shape == want.shape, (layer, leaf)
            assert _rel(got, want) <= 2e-2, (layer, leaf, _rel(got, want))
            assert float((got - want).norm() / want.norm()) <= 1e-2, (layer, leaf)
    # deterministic: no atomics in the reduction
    again, _ = K.fused_resnet_fc_tz_bwd(params, cfg, tz, x, gy, d_out)
    assert torch.equal(again["lin_in"]["kernel"], grads["lin_in"]["kernel"])


def test_k7tz_function_matches_plain_autograd(dev):
    """autograd.grad through fused_resnet_fc_train_tz against autograd of the
    plain forward, whose backward rounds the gradient to bf16 at every cast:
    5e-2 of scale; x gets no gradient from the kernel's Function."""
    params, cfg, tz, x, gy = _k7_case(dev, 2000, 64, 3, 3, 16, 10)
    leaves = [params["lin_in"]["kernel"], params["blocks_0_fc_0"]["kernel"],
              params["lin_out"]["bias"]]
    for t in (*leaves, tz):
        t.requires_grad_()
    out = K.fused_resnet_fc_train_tz(params, cfg, tz, x, 16)
    got = torch.autograd.grad(out, (*leaves, tz), gy)
    want = torch.autograd.grad(K.fused_resnet_fc_tz_plain(params, cfg, tz, x, 16),
                               (*leaves, tz), gy)
    for a, b in zip(got, want):
        assert _rel(a, b) <= 5e-2


def test_cuda_outputs_carry_grad_fn(dev):
    """Regression: every differentiable entry point keeps the autograd graph
    on the card, and a loss through the encoder reaches every conv weight."""
    from neural_jacobian_field_torch.models.encoder_resnet import (
        EncoderResnet, EncoderResnetCfg)

    g = _gen(11)
    x = torch.randn((1, 8, 10, 16), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((3, 3, 16, 16), generator=g, device=dev, requires_grad=True)
    assert K.conv_s1(x, w).grad_fn is not None
    lvl = torch.randn((1, 4, 6, 8), generator=g, device=dev, requires_grad=True)
    assert K.pack_2x2_flat_train(lvl).grad_fn is not None
    assert all(t.grad_fn is not None for t in K.conv_s1_stats(x, w))
    params, cfg, tz, xx, _ = _k7_case(dev, 100, 32, 2, 3, 16, 12)
    tz.requires_grad_()
    assert K.fused_resnet_fc_train_tz(params, cfg, tz, xx, 16).grad_fn is not None

    for conv_impl in ("pallas", "pallas_fused"):
        enc = EncoderResnet(EncoderResnetCfg(norm_type="batch", conv_impl=conv_impl),
                            torch.bfloat16)
        enc.init_weights(torch.Generator().manual_seed(0))
        enc = enc.to(dev)
        n0 = K.conv3x3_s1_stats.launches
        pyr = enc(torch.rand((2, 64, 96, 3), generator=g, device=dev), train=True)
        assert K.conv3x3_s1_stats.launches - n0 == (24 if conv_impl == "pallas_fused" else 0)
        (pyr.fine.float().sum() + pyr.mid.float().sum() + pyr.coarse.float().sum()).backward()
        for name, p in enc.named_parameters():
            assert p.grad is not None and bool(p.grad.abs().sum() > 0), (conv_impl, name)


def test_kernels_reject_what_they_do_not_take(dev):
    with pytest.raises(TypeError):
        K.conv3x3_s1(torch.randn((1, 4, 4, 8), device=dev), torch.randn((3, 3, 8, 8), device=dev))
    with pytest.raises(TypeError):
        K.conv3x3_s1_wgrad(torch.randn((1, 4, 4, 8), device=dev),
                           torch.randn((1, 4, 4, 8), device=dev))
    with pytest.raises(TypeError):
        K.pack_2x2_flat_bwd(torch.randn((1, 16, 32), device=dev, dtype=torch.float64), 4)


# ------------------------------------------------- the exact path: K1 and K7

def _corner_ids(cx, cy, wc, hc):
    from neural_jacobian_field_torch.ops.pixel_gather import _corner_ids as corner_ids

    return corner_ids(cx, cy, wc, hc)


def _corner_inputs(dev, b, n, hc, wc, g):
    cx = torch.rand((b, n), generator=g, device=dev) * (wc + 3) - 2
    cy = torch.rand((b, n), generator=g, device=dev) * (hc + 3) - 2
    return _corner_ids(cx, cy, wc, hc)


@pytest.mark.parametrize("b,n,hc,wc,c,dtype", [
    (2, 1500, 5, 7, 24, torch.float32),
    (1, 700, 6, 9, 12, torch.bfloat16),     # C not a multiple of 8: scalar path
    (2, 333, 2, 3, 6, torch.float32),
    (7, 65536, 30, 40, 256, torch.bfloat16),  # the train step's coarse level
])
def test_k1_fwd_is_bit_exact(dev, b, n, hc, wc, c, dtype):
    """The same float32 products (weights rounded to the map's dtype), summed
    in the same corner order with no fused multiply-add: equal bits."""
    g = _gen(13)
    idx, w4 = _corner_inputs(dev, b, n, hc, wc, g)
    flat = torch.randn((b, hc * wc, c), generator=g, device=dev).to(dtype)
    n0 = K.onehot_gather_fwd.launches
    got = K.onehot_gather_fwd(flat, idx, w4)
    torch.cuda.synchronize()
    assert K.onehot_gather_fwd.launches == n0 + 1
    assert got.dtype == torch.float32 and torch.equal(got, K.onehot_gather_fwd_plain(flat, idx, w4))


@pytest.mark.parametrize("b,n,hc,wc,c,dtype", [
    (2, 1500, 5, 7, 24, torch.float32),
    (1, 2100, 6, 9, 40, torch.bfloat16),    # C not a multiple of 32
    (2, 333, 2, 3, 6, torch.float32),       # one point range
    (7, 65536, 30, 40, 256, torch.bfloat16),
])
def test_k1_bwd_matches_plain_and_repeats(dev, b, n, hc, wc, c, dtype):
    """The same float32 products summed over the points in another order
    (per-range partials, then the ranges in order): 1e-5 of scale at these
    sizes; two calls give identical bits (no atomics)."""
    g = _gen(14)
    idx, w4 = _corner_inputs(dev, b, n, hc, wc, g)
    gy = torch.randn((b, n, c), generator=g, device=dev).to(dtype)
    n0 = K.onehot_scatter_bwd.launches
    got = K.onehot_scatter_bwd(gy, idx, w4, hc * wc)
    torch.cuda.synchronize()
    assert K.onehot_scatter_bwd.launches == n0 + 1
    want = K.onehot_scatter_bwd_plain(gy, idx, w4, hc * wc)
    assert got.dtype == torch.float32 and got.shape == want.shape == (b, hc * wc, c)
    assert _rel(got, want) <= 1e-5
    assert torch.equal(K.onehot_scatter_bwd(gy, idx, w4, hc * wc), got)


def _k7_exact_case(dev, n, dh, n_blocks, combine, d_out, widths, seed):
    """Trunk params with lin_z kernels, the latent as levels (the last in
    float32, as K1-fwd gives the coarse level) or one bf16 array."""
    from neural_jacobian_field_torch.models.resnet_fc import MlpCfg

    g = _gen(seed)
    params, n_lin_z = _trunk(dev, 63, dh, n_blocks, combine, d_out, g)
    d_lat = sum(widths)
    for i in range(n_lin_z):
        params[f"lin_z_{i}"]["kernel"] = (torch.randn((d_lat, dh), generator=g, device=dev)
                                          / math.sqrt(d_lat))
    cfg = MlpCfg(n_blocks=n_blocks, d_hidden=dh, combine_layer=combine)
    levels = [torch.randn((n, w), generator=g, device=dev) for w in widths]
    levels = tuple(t if i == len(levels) - 1 and len(levels) > 1 else t.to(torch.bfloat16)
                   for i, t in enumerate(levels))
    z = levels if len(levels) > 1 else levels[0]
    x = (torch.rand((n, 63), generator=g, device=dev) * 2 - 1).to(torch.bfloat16)
    gy = torch.randn((n, d_out), generator=g, device=dev)
    return params, cfg, z, x, gy


_K7_EXACT = [
    (700, 32, 2, 3, 16, (64,)),
    (333, 64, 3, 2, 24, (16, 32, 48)),
    (1000, 64, 2, 0, 8, (32, 32)),               # no latent injection
    (65536, 128, 5, 3, 1, (128, 128, 256)),      # the proposal trunk
    (4099, 128, 5, 3, 24, (128, 128, 256)),      # the Jacobian trunk, ragged tile
    (65536, 128, 5, 3, 24, (128, 128, 256)),     # the Jacobian trunk of stage 2
]


@pytest.mark.parametrize("n,dh,n_blocks,combine,d_out,widths", _K7_EXACT)
def test_k7_fwd_kernel_matches_plain(dev, n, dh, n_blocks, combine, d_out, widths):
    """Same bf16 operations and casts; only the accumulation order differs
    (the projection's too), which can flip a bf16 rounding that later layers
    carry: 1e-2 of scale, as K7-tz-fwd."""
    params, cfg, z, x, _ = _k7_exact_case(dev, n, dh, n_blocks, combine, d_out, widths, 15)
    n0 = K.fused_resnet_fc.launches
    got = K.fused_resnet_fc(params, cfg, z, x, d_out)
    torch.cuda.synchronize()
    assert K.fused_resnet_fc.launches == n0 + 1
    want = K.fused_resnet_fc_plain(params, cfg, z, x, d_out)
    assert got.shape == want.shape == (n, d_out)
    assert (got - want).abs().max() <= 1e-2 * want.abs().max()


@pytest.mark.parametrize("n,dh,n_blocks,combine,d_out,widths", _K7_EXACT)
def test_k7_bwd_matches_plain_and_repeats(dev, n, dh, n_blocks, combine, d_out, widths):
    """The bounds of K7-tz-bwd (a bf16 recompute rounding may flip a ReLU
    mask): every dW/db leaf, the lin_z kernels included, within 2e-2 of its
    scale and 1e-2 in l2; each level's dz, in the level's dtype, within 1e-2
    in l2 and at most 1e-3 of its elements further than 2e-2 of scale. Two
    calls give identical bits."""
    params, cfg, z, x, gy = _k7_exact_case(dev, n, dh, n_blocks, combine, d_out, widths, 16)
    n0 = K.fused_resnet_fc_bwd.launches
    grads, dz = K.fused_resnet_fc_bwd(params, cfg, z, x, gy, d_out)
    torch.cuda.synchronize()
    assert K.fused_resnet_fc_bwd.launches == n0 + 1
    pgrads, pdz = K.fused_resnet_fc_bwd_plain(params, cfg, z, x, gy, d_out)
    levels = z if isinstance(z, tuple) else (z,)
    dz, pdz = (dz, pdz) if isinstance(z, tuple) else ((dz,), (pdz,))
    for lvl, a, b in zip(levels, dz, pdz):
        assert a.dtype == lvl.dtype and a.shape == lvl.shape
        if not b.float().abs().max():
            assert not a.float().abs().max()
            continue
        err = (a.float() - b.float()).abs()
        assert float(err.norm() / b.float().norm()) <= 1e-2
        assert float((err > 2e-2 * b.float().abs().max()).float().mean()) <= 1e-3
    assert set(grads) == set(pgrads)
    for layer, leaves in pgrads.items():
        assert set(grads[layer]) == set(leaves), layer
        for leaf, want in leaves.items():
            got = grads[layer][leaf]
            assert got.dtype == torch.float32 and got.shape == want.shape, (layer, leaf)
            assert _rel(got, want) <= 2e-2, (layer, leaf, _rel(got, want))
            assert float((got - want).norm() / want.norm().clamp_min(1e-30)) <= 1e-2, (layer, leaf)
    again, dz2 = K.fused_resnet_fc_bwd(params, cfg, z, x, gy, d_out)
    for layer, leaves in grads.items():
        for leaf, v in leaves.items():
            assert torch.equal(again[layer][leaf], v), (layer, leaf)
    for a, b in zip(dz, dz2 if isinstance(dz2, tuple) else (dz2,)):
        assert torch.equal(a, b)


def test_exact_functions_carry_grad_fn(dev):
    """The exact path's differentiable entry points keep the graph on the
    card and give the coordinates no gradient."""
    from neural_jacobian_field_torch.ops.pixel_gather import gather_bilinear_onehot

    g = _gen(17)
    level = torch.randn((2, 5, 7, 16), generator=g, device=dev).to(torch.bfloat16)
    level.requires_grad_()
    cx = (torch.rand((2, 100), generator=g, device=dev) * 7).requires_grad_()
    cy = torch.rand((2, 100), generator=g, device=dev) * 5
    out = gather_bilinear_onehot(level, cx, cy)
    assert out.grad_fn is not None and out.dtype == torch.float32
    out.sum().backward()
    assert level.grad is not None and level.grad.dtype == torch.bfloat16 and cx.grad is None
    params, cfg, z, x, _ = _k7_exact_case(dev, 100, 32, 2, 3, 16, (16, 32), 18)
    z = tuple(t.clone().requires_grad_() for t in z)
    assert K.fused_resnet_fc_train(params, cfg, z, x, 16).grad_fn is not None


@pytest.mark.parametrize("b,n,hc,wc,c,dtype,hot", [
    (7, 65536, 45, 80, 256, torch.bfloat16, 0),   # a 720x1280 image's layer3: K = 3,600
    (2, 5000, 30, 40, 16, torch.bfloat16, 5000),  # every point on one spot
    (1, 4000, 100, 200, 8, torch.float32, 500),   # K = 20,000: the counters in global memory
])
def test_k1_bwd_takes_large_maps_and_hot_texels(dev, b, n, hc, wc, c, dtype, hot):
    """Large maps (a 720x1280 image's layer3; 20,000 texels, past the
    shared-memory counters), one texel whose entries span many pieces,
    untouched texels: 1e-5 of scale against the plain version,
    untouched texels zero, two calls bit-identical."""
    g = _gen(19)
    cx = torch.rand((b, n), generator=g, device=dev) * (wc + 3) - 2
    cy = torch.rand((b, n), generator=g, device=dev) * (hc + 3) - 2
    cx[:, :hot], cy[:, :hot] = 3.3, 4.6
    idx, w4 = _corner_ids(cx, cy, wc, hc)
    gy = torch.randn((b, n, c), generator=g, device=dev).to(dtype)
    got = K.onehot_scatter_bwd(gy, idx, w4, hc * wc)
    want = K.onehot_scatter_bwd_plain(gy, idx, w4, hc * wc)
    assert got.shape == want.shape == (b, hc * wc, c)
    assert _rel(got, want) <= 1e-5
    assert not got[want.abs().sum(-1) == 0].any()
    assert torch.equal(K.onehot_scatter_bwd(gy, idx, w4, hc * wc), got)


@pytest.mark.parametrize("b,n,hc,wc,c,dtype,hot", [
    (2, 2100, 6, 9, 40, torch.bfloat16, 700),
    (1, 3000, 45, 80, 6, torch.float32, 0),
])
def test_k1_bwd_is_its_emulation(dev, b, n, hc, wc, c, dtype, hot):
    """The bucket sort, the piece sums and the ordered merge, emulated on the
    CPU in the kernels' order, equal the kernels' output bit for bit."""
    from test_torch_port_k5_k1bwd_plan import k1_emulate

    g = _gen(20)
    cx = torch.rand((b, n), generator=g, device=dev) * (wc + 3) - 2
    cy = torch.rand((b, n), generator=g, device=dev) * (hc + 3) - 2
    cx[:, :hot], cy[:, :hot] = 1.5, 2.5
    idx, w4 = _corner_ids(cx, cy, wc, hc)
    gy = torch.randn((b, n, c), generator=g, device=dev).to(dtype)
    got = K.onehot_scatter_bwd(gy, idx, w4, hc * wc)
    plan = K.onehot_gather.bwd_plan(b, n, hc * wc, c, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    assert torch.equal(got.cpu(), k1_emulate(gy.cpu(), idx.cpu(), w4.cpu(), hc * wc, plan))


@pytest.mark.parametrize("b,n,k,c,dtype,hot,q,weighted,shared", [
    (2, 16384, 76800, 512, torch.bfloat16, 0, 1, False, False),  # the fine knots' map and width
    (2, 6000, 20000, 1024, torch.bfloat16, 2000, 1, False, False),  # 1,024 wide, 16 pieces
    (3, 5000, 900, 40, torch.float32, 700, 1, False, False),      # float32, a hot row
    (1, 8000, 300, 24, torch.bfloat16, 6000, 1, False, False),    # 32 pieces of 188
    (2, 9000, 50, 16, torch.float32, -3, 1, False, False),        # 3 rows of 24 pieces a block
    (2, 3000, 300, 13, torch.float32, 300, 4, True, True),        # corners, one table, 13 wide
    (64, 512, 257, 1, torch.float32, 200, 1, False, False),       # one-wide rows, many images
])
def test_row_scatter_is_its_emulation(dev, b, n, k, c, dtype, hot, q, weighted, shared):
    """K1-bwd-rows bit for bit rows_emulate (its order, on the CPU), in g's
    dtype, counted once a call; two calls bit-identical; rows no entry
    takes exactly zero."""
    from test_torch_port_k5_k1bwd_plan import _rows_case, rows_emulate

    g, idx, w = _rows_case(23, b, n, k, c, dtype, q, max(hot, 0), weighted, shared)
    if hot < 0:  # -h: rows 1, 3, ... 2h - 1 take 3,000 entries each: the queue's 64 pieces
        for i in range(-hot):  # take two rows', the third is summed after the queue
            idx[:, 3000 * i:3000 * (i + 1)] = 2 * i + 1
    gd, idxd = g.to(dev), idx.to(dev)
    wd = None if w is None else w.to(dev)
    n0 = K.row_scatter.launches
    got = K.row_scatter(gd, idxd, wd, k)
    torch.cuda.synchronize()
    assert K.row_scatter.launches == n0 + 1 and got.dtype == dtype and got.shape == (b, k, c)
    assert torch.equal(got.cpu(), rows_emulate(g, idx, w, k, K.onehot_gather.ROWS_PIECE))
    assert torch.equal(K.row_scatter(gd, idxd, wd, k), got)
    counts = torch.stack([torch.bincount(t.reshape(-1), minlength=k)
                          for t in idx.expand(b, -1, -1)])
    assert not got.cpu()[counts == 0].any()


@pytest.mark.parametrize("b,n,k,c,dtype,hot", [
    (2, 9000, 50, 16, torch.float32, -3),      # 3 rows of 24 pieces a block: past the queue
    (1, 8000, 300, 24, torch.bfloat16, 6000),  # 32 pieces of 188
])
def test_row_scatter_one_thread_block_a_block_is_its_emulation(dev, monkeypatch, b, n, k, c,
                                                               dtype, hot):
    """With each texel block on one thread block of the sums (a large call's
    plan; forced here, where the plan would deal the blocks), the queue sums
    its pieces in shared memory and a block of more than 64 pieces sums the
    rest texel by texel: bit for bit rows_emulate, as the dealt blocks are."""
    from test_torch_port_k5_k1bwd_plan import _rows_case, rows_emulate

    g, idx, w = _rows_case(23, b, n, k, c, dtype, 1, max(hot, 0))
    for i in range(-hot):
        idx[:, 3000 * i:3000 * (i + 1)] = 2 * i + 1
    monkeypatch.setattr(K.onehot_gather, "ROWS_DEAL_CTAS_PER_SM", 0)
    K.onehot_gather.rows_plan.cache_clear()
    try:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        assert K.onehot_gather.rows_plan(b, n, k, c, sms).splits == 1
        got = K.row_scatter(g.to(dev), idx.to(dev), None, k)
        torch.cuda.synchronize()
    finally:
        K.onehot_gather.rows_plan.cache_clear()
    assert torch.equal(got.cpu(), rows_emulate(g, idx, w, k, K.onehot_gather.ROWS_PIECE))


@pytest.mark.parametrize("b,m,k,c,dtype", [
    (7, 4096, 4800, 512, torch.bfloat16),   # the mid knots' shape
    (2, 3000, 20000, 1024, torch.float32),
])
def test_gather_rows_gradient_is_row_scatter(dev, b, m, k, c, dtype):
    """gather_rows's backward, where small_plan does not admit the shape,
    launches K1-bwd-rows once, and flat's gradient is the kernel's output."""
    from neural_jacobian_field_torch.ops.deterministic import gather_rows

    g = _gen(24)
    idx = torch.randint(0, k, (b, m), generator=g, device=dev)
    gy = torch.randn((b, m, c), generator=g, device=dev).to(dtype)
    flat = torch.zeros((b, k, c), dtype=dtype, device=dev, requires_grad=True)
    assert K.small_plan(m, k, c) is None
    n0 = K.row_scatter.launches
    (gf,) = torch.autograd.grad(gather_rows(flat, idx), flat, gy)
    assert K.row_scatter.launches == n0 + 1
    assert torch.equal(gf, K.row_scatter(gy, idx[..., None], None, k))


@pytest.mark.parametrize("b,hi,wi,ho,wo,c,dtype", [
    (2, 30, 40, 60, 80, 64, torch.bfloat16),   # 2x, 32 bytes a thread (4 lanes a texel)
    (2, 15, 20, 60, 80, 128, torch.float32),   # 4x, 16 bytes a thread
    (1, 6, 8, 48, 64, 256, torch.float32),     # 8x, a tile of 2x2 texels
    (3, 5, 4, 12, 11, 12, torch.bfloat16),     # a ratio that is not an integer, 12 channels
    (2, 7, 9, 5, 4, 6, torch.float32),         # a downscale, 6 channels
])
def test_upsample_bwd_is_its_plain_version(dev, b, hi, wi, ho, wo, c, dtype):
    """K1-bwd-upsample bit for bit its plain version on the CPU (the corner
    table scattered in entry order), the vector and the scalar paths, NaN
    where the plain version has it, two calls bit-identical; the
    autograd.Function's gradient the kernel's."""
    from neural_jacobian_field_torch.ops.deterministic import upsample_bilinear

    g = torch.randn((b, ho, wo, c), generator=_gen(21), device=dev).to(dtype)
    g[0, ho - 1, 0, 1] = float("nan")
    got = K.upsample_bilinear_bwd(g, (hi, wi))
    want = K.upsample_bilinear_bwd_plain(g.cpu(), (hi, wi))
    assert got.dtype == dtype and got.shape == (b, hi, wi, c)
    assert torch.equal(got.isnan().cpu(), want.isnan())
    assert torch.equal(got.cpu().nan_to_num(), want.nan_to_num())
    assert torch.equal(K.upsample_bilinear_bwd(g, (hi, wi)).nan_to_num(), got.nan_to_num())
    x = torch.zeros((b, hi, wi, c), dtype=dtype, device=dev, requires_grad=True)
    (gx,) = torch.autograd.grad(upsample_bilinear(x, (ho, wo)), x, g)
    assert torch.equal(gx.nan_to_num(), got.nan_to_num())


@pytest.mark.parametrize("b,n,k,c,dtype,hot,sort", [
    (1792, 512, 257, 1, torch.float32, 0, True),    # the interlevel loss
    (64, 700, 37, 1, torch.bfloat16, 300, False),   # unsorted, a hot row
    (16, 300, 60, 40, torch.float32, 90, False),    # rows wider than a warp
    (8, 4096, 3, 4096, torch.bfloat16, 0, False),   # the plan's longest image, a 48 KB map
])
def test_small_scatter_is_its_plain_version(dev, b, n, k, c, dtype, hot, sort):
    """K1-bwd-small bit for bit its plain version on the CPU, two calls
    bit-identical; gather_rows's backward launches it where small_plan
    admits the shape."""
    from neural_jacobian_field_torch.ops.deterministic import gather_rows

    gen = _gen(22)
    idx = torch.randint(0, k, (b, n), generator=gen, device=dev)
    idx[:, :hot] = k // 2
    if sort:
        idx = idx.sort(dim=1).values
    g = torch.randn((b, n, c), generator=gen, device=dev).to(dtype)
    assert K.small_plan(n, k, c) is not None
    got = K.small_scatter(g, idx, k)
    assert got.dtype == dtype and got.shape == (b, k, c)
    assert torch.equal(got.cpu(), K.small_scatter_plain(g.cpu(), idx.cpu(), k))
    assert torch.equal(K.small_scatter(g, idx, k), got)
    flat = torch.zeros((b, k, c), dtype=dtype, device=dev, requires_grad=True)
    n0 = K.small_scatter.launches
    (gf,) = torch.autograd.grad(gather_rows(flat, idx), flat, g)
    assert K.small_scatter.launches == n0 + 1 and torch.equal(gf, got)


def test_stage2_step_on_the_card_freezes_all_but_the_head(dev):
    """Two stage-2 steps of a small pallas_fused bf16 model with flow
    supervision: K10 runs 24 times per step and no encoder backward kernel
    runs; every parameter outside decoder.jacobian_head is bit for bit
    unchanged; the head and the BatchNorm running statistics move."""
    from dataclasses import replace

    from neural_jacobian_field_torch.models.decoders import ActionDecoderJacobianMlpCfg
    from neural_jacobian_field_torch.models.decoders import DensityDecoderMlpCfg
    from neural_jacobian_field_torch.models.model import Model, flagship_model_cfg
    from neural_jacobian_field_torch.models.resnet_fc import MlpCfg
    from neural_jacobian_field_torch.training import RawBatch, TrainCfg, create_train_state
    from neural_jacobian_field_torch.training import train_step

    mlp = MlpCfg(n_blocks=2, d_hidden=32, combine_layer=3)
    cfg = flagship_model_cfg(conv_impl="pallas_fused", num_proposal_samples=(8,),
                             num_nerf_samples=8, epipolar_knots=(8, 4, 2))
    cfg = replace(cfg, action_dim=4, density_decoder=DensityDecoderMlpCfg(mlp=mlp),
                  action_decoder=ActionDecoderJacobianMlpCfg(mlp=mlp))
    model = Model(cfg, compute_dtype=torch.bfloat16)
    model.init_weights(torch.Generator().manual_seed(0)).to(dev)
    state = create_train_state(model, TrainCfg(mode="action", lr=1e-3, warm_up_steps=2,
                                               rays_per_batch=16))
    g = _gen(21)
    b, h, w = 2, 64, 96
    intr = torch.tensor([[1.2, 0.0, 0.5], [0.0, 1.6, 0.5], [0.0, 0.0, 1.0]], device=dev)
    trgt = torch.eye(4, device=dev)
    trgt[0, 3] = 0.1
    batch = RawBatch(
        ctxt_rgb=torch.rand((b, h, w, 3), generator=g, device=dev),
        ctxt_extrinsics=torch.eye(4, device=dev).expand(b, 4, 4),
        ctxt_intrinsics=intr.expand(b, 3, 3), robot_action=torch.randn((b, 4), device=dev),
        trgt_rgb=torch.rand((b, h, w, 3), generator=g, device=dev),
        trgt_depth=1.0 + torch.rand((b, h, w, 1), generator=g, device=dev),
        trgt_extrinsics=trgt.expand(b, 4, 4), trgt_intrinsics=intr.expand(b, 3, 3),
        near=torch.full((b,), 0.5, device=dev), far=torch.full((b,), 4.0, device=dev),
        flow=torch.randn((b, h, w, 2), generator=g, device=dev))
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: t.clone() for n, t in model.named_buffers()}
    K.reset_launch_counts()
    for updated in (True, False):
        metrics = train_step(state, batch, g, updated)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert counts["K10"] == 48 and counts["K7-tz-bwd"] == 2, counts
    assert counts["K9-fwd"] == counts["K9-dgrad"] == counts["K9-wgrad"] == counts["K6-bwd"] == 0
    assert torch.isfinite(metrics["loss/flow"])
    for n, p in model.named_parameters():
        moved = not torch.equal(p.detach(), params0[n])
        assert moved == n.startswith("decoder.jacobian_head."), n
    assert all(not torch.equal(t, stats0[n]) for n, t in model.named_buffers()
               if n.endswith("running_mean"))


# ------------------------------------------- the TMA + wgmma K9 template

def _conv_inputs(shape, cout, seed):
    g = _gen(seed)
    x = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn((3, 3, shape[-1], cout), generator=g, device="cuda")
         / math.sqrt(9 * shape[-1])).to(torch.bfloat16)
    gy = torch.randn((*shape[:3], cout), generator=g, device="cuda").to(torch.bfloat16)
    return x, w, gy


def _within_one_rounding(got, want):
    err = (got.float() - want.float()).abs()
    return bool((err <= 2.0 ** -7 * want.float().abs() + 1e-3).all())


def _check_stats(x, w, y, s1, s2):
    _, p1, p2 = K.conv3x3_s1_stats_plain(x, w)
    n = x.shape[0] * x.shape[1] * x.shape[2]
    assert float(((s2 - p2).abs() / p2.clamp_min(1e-30)).max()) <= 1e-4
    assert float(((s1 - p1).abs() / (n * p2).sqrt().clamp_min(1e-30)).max()) <= 1e-4


@pytest.mark.parametrize("b", [1, 7])
@pytest.mark.parametrize("h,w,c", [(120, 160, 64), (60, 80, 128), (30, 40, 256)])
def test_k9_tma_path_at_encoder_shapes(dev, b, h, w, c):
    """K9-fwd, K9-dgrad, K10 and K9-wgrad on the TMA + wgmma path at the
    encoder's three shapes, at serving (B = 1) and training (batch 7) size,
    bf16 weights as the model passes them: fwd and dgrad within one bf16
    rounding, K10's y bit for bit K9-fwd's and its sums within 1e-4, wgrad
    within 1e-4 of scale; K10 and wgrad give identical bits twice; no legacy
    launch."""
    x, wt, gy = _conv_inputs((b, h, w, c), c, 22)
    legacy0 = K.legacy_launch_counts()
    y = K.conv3x3_s1(x, wt)
    assert _within_one_rounding(y, K.conv3x3_s1_plain(x, wt))
    assert _within_one_rounding(K.conv3x3_s1_dgrad(gy, wt), K.conv3x3_s1_dgrad_plain(gy, wt))
    ys, s1, s2 = K.conv3x3_s1_stats(x, wt)
    assert torch.equal(ys, y)
    _check_stats(x, wt, ys, s1, s2)
    again = K.conv3x3_s1_stats(x, wt)
    assert all(torch.equal(a, b_) for a, b_ in zip((ys, s1, s2), again))
    dw = K.conv3x3_s1_wgrad(x, gy)
    assert _rel(dw, K.conv3x3_s1_wgrad_plain(x, gy)) <= 1e-4
    assert torch.equal(dw, K.conv3x3_s1_wgrad(x, gy))
    torch.cuda.synchronize()
    assert K.legacy_launch_counts() == legacy0


@pytest.mark.parametrize("shape,cout,patch,wpatch", [
    ((2, 30, 40, 64), 64, (8, 16), (8, 8)),      # th = 8 at H = 30: the last patch row hangs
    ((1, 30, 33, 128), 128, (8, 16), (4, 16)),   # tw = 16 at W = 33: 15 columns hang over
    ((2, 30, 40, 72), 72, (16, 8), (2, 32)),     # C, Cout multiples of 8 but not of 64
    ((1, 17, 33, 8), 80, (8, 16), (8, 8)),       # one 8-channel chunk, Cout 80: ragged n tile
    ((3, 9, 11, 136), 24, (8, 16), (2, 32)),     # the patch larger than the image
    ((1, 30, 33, 64), 136, (8, 8), (8, 8)),      # 64-pixel patches hanging both ways
])
def test_k9_tma_ragged_patches(dev, shape, cout, patch, wpatch):
    """Forced patches that hang over the bottom or right edge: the hanging
    rows read real neighbours, so they must stay out of y and K10's sums;
    in wgrad their g is zero-filled. Bounds as at the encoder's shapes."""
    from neural_jacobian_field_torch.ops.kernels import conv_suite as cs

    b, h, w, c = shape
    x, wt, gy = _conv_inputs(shape, cout, 23)
    plan = cs.conv_plan(b, h, w, c, cout, patch=patch)
    y = cs._conv3x3_s1_cuda(x, wt, K.conv3x3_s1, plan=plan)
    assert _within_one_rounding(y, K.conv3x3_s1_plain(x, wt))
    ys, s1, s2 = cs._conv3x3_s1_stats_cuda(x, wt, plan=plan)
    assert torch.equal(ys, y)
    _check_stats(x, wt, ys, s1, s2)
    dx = cs._conv3x3_s1_cuda(gy, wt, K.conv3x3_s1_dgrad, dgrad=True,
                             plan=cs.conv_plan(b, h, w, cout, c, patch=patch))
    assert _within_one_rounding(dx, K.conv3x3_s1_dgrad_plain(gy, wt))
    dw = cs._conv3x3_s1_wgrad_cuda(x, gy, plan=cs.wgrad_plan(b, h, w, c, cout, patch=wpatch))
    assert _rel(dw, K.conv3x3_s1_wgrad_plain(x, gy)) <= 1e-4


@pytest.mark.parametrize("c,cout,legacy", [
    (12, 20, True), (64, 20, True), (12, 64, True), (8, 16, False), (72, 64, False)])
def test_legacy_counter_moves_only_for_unaligned_channels(dev, c, cout, legacy):
    """The legacy kernels run exactly for C or Cout not a multiple of 8 (the
    dgrad's C is the forward's Cout), and agree with the plain versions."""
    x, wt, gy = _conv_inputs((2, 6, 10, c), cout, 24)
    K.reset_launch_counts()
    assert _within_one_rounding(K.conv3x3_s1(x, wt), K.conv3x3_s1_plain(x, wt))
    assert _within_one_rounding(K.conv3x3_s1_dgrad(gy, wt), K.conv3x3_s1_dgrad_plain(gy, wt))
    _, s1, s2 = K.conv3x3_s1_stats(x, wt)
    _check_stats(x, wt, None, s1, s2)
    assert _rel(K.conv3x3_s1_wgrad(x, gy), K.conv3x3_s1_wgrad_plain(x, gy)) <= 1e-4
    torch.cuda.synchronize()
    names = ("K9-fwd", "K9-dgrad", "K10", "K9-wgrad")
    assert {n: K.launch_counts()[n] for n in names} == dict.fromkeys(names, 1)
    assert {n: K.legacy_launch_counts()[n] for n in names} == dict.fromkeys(names, int(legacy))


@pytest.mark.parametrize("shape,cout", [((2, 60, 80, 128), 128), ((2, 30, 40, 72), 72)])
def test_conv_functions_on_the_tma_path(dev, shape, cout):
    """ConvS1 and ConvS1Stats (K9-fwd / K10 forward, K9-dgrad and K9-wgrad
    backward) against plain autograd, at the bounds of the K9 Function (dx
    3e-2, dW 1e-2 of scale)."""
    x, wt, gy = _conv_inputs(shape, cout, 25)
    x = x.requires_grad_()
    w = wt.float().requires_grad_()
    dx, dw = torch.autograd.grad(K.conv_s1(x, w), (x, w), gy)
    px, pw = torch.autograd.grad(K.conv3x3_s1_plain(x, w), (x, w), gy)
    assert _rel(dx, px) <= 3e-2 and _rel(dw, pw) <= 1e-2
    g = _gen(26)
    cts = (gy, torch.randn((cout,), generator=g, device=dev),
           1e-3 * torch.randn((cout,), generator=g, device=dev))
    dx, dw = torch.autograd.grad(K.conv_s1_stats(x, w), (x, w), cts)
    px, pw = torch.autograd.grad(K.conv3x3_s1_stats_plain(x, w), (x, w), cts)
    assert _rel(dx, px) <= 3e-2 and _rel(dw, pw) <= 1e-2


# ------------------------------------- K7-fwd / K7-tz-fwd: the wgmma kernel

_K7_WG = [  # (projection mode, n, n_blocks, combine, d_out, latent widths)
    (False, 4099, 0, 3, 16, None),             # lin_in and lin_out only
    (False, 65536, 0, 3, 24, None),
    (False, 4099, 5, 3, 1, None),              # ragged tile, the proposal trunk
    (False, 65537, 5, 3, 16, None),            # one point past a tile
    (False, 50, 5, 3, 24, None),               # fewer points than one tile
    (False, 4099, 5, 0, 16, None),             # no injection
    (True, 4099, 0, 3, 16, (128, 128, 256)),
    (True, 65537, 5, 3, 24, (128, 128, 256)),  # the f32 coarse level
    (True, 50, 5, 3, 1, (128, 128, 256)),
    (True, 4099, 5, 0, 16, (128, 128, 256)),
    (True, 4099, 5, 3, 16, (512,)),            # one bf16 level
]


def _k7_wg_case(dev, proj, n, n_blocks, combine, d_out, widths, seed):
    if proj:
        params, cfg, z, x, gy = _k7_exact_case(dev, n, 128, n_blocks, combine, d_out, widths,
                                               seed)
        return (K.fused_resnet_fc, K.fused_resnet_fc_plain, params, cfg, z, x, gy)
    params, cfg, tz, x, gy = _k7_case(dev, n, 128, n_blocks, combine, d_out, seed)
    return K.fused_resnet_fc_tz, K.fused_resnet_fc_tz_plain, params, cfg, tz, x, gy


@pytest.mark.parametrize("proj,n,n_blocks,combine,d_out,widths", _K7_WG)
def test_k7_fwd_wgmma_matches_plain_and_repeats(dev, proj, n, n_blocks, combine, d_out, widths):
    """The wgmma kernel (d_hidden 128) against the plain version: the same bf16
    operations and casts in another accumulation order, 1e-2 of scale as the
    legacy kernel; no launch reaches the legacy kernel, and two calls give
    identical bits (no reduction crosses points)."""
    wrapper, plain, params, cfg, lat, x, _ = _k7_wg_case(dev, proj, n, n_blocks, combine, d_out,
                                                          widths, 30)
    n0, l0 = wrapper.launches, wrapper.legacy_launches
    got = wrapper(params, cfg, lat, x, d_out)
    again = wrapper(params, cfg, lat, x, d_out)
    torch.cuda.synchronize()
    assert (wrapper.launches - n0, wrapper.legacy_launches - l0) == (2, 0)
    want = plain(params, cfg, lat, x, d_out)
    assert got.shape == want.shape == (n, d_out)
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max() <= 1e-2 * want.abs().max()
    assert torch.equal(got, again)


@pytest.mark.parametrize("proj", [False, True])
def test_k7_functions_forward_through_wgmma(dev, proj):
    """fused_resnet_fc_train{,_tz} at d_hidden 128: the forward inside
    autograd runs the wgmma kernel and agrees with the plain forward (1e-2
    of scale). The backward (the wgmma backward, recomputing the forward)
    then reaches a few leaves and the latent: within 5e-2 in l2 of plain
    autograd, whose backward rounds the gradient to bf16 at
    every cast (through 5 blocks single elements move further: 9.5e-2 of
    scale measured on an H100)."""
    widths = (128, 128, 256) if proj else None
    wrapper, plain, params, cfg, lat, x, gy = _k7_wg_case(dev, proj, 4099, 5, 3, 24, widths, 31)
    leaves = [params["lin_in"]["kernel"], params["blocks_2_fc_1"]["kernel"],
              params["lin_out"]["bias"]]
    lats = list(lat) if proj else [lat]
    for t in (*leaves, *lats):
        t.requires_grad_()
    fn = K.fused_resnet_fc_train if proj else K.fused_resnet_fc_train_tz
    l0 = wrapper.legacy_launches
    out = fn(params, cfg, lat, x, 24)
    assert out.grad_fn is not None and wrapper.legacy_launches == l0
    ref = plain(params, cfg, lat, x, 24)
    assert (out - ref).abs().max() <= 1e-2 * ref.abs().max()
    got = torch.autograd.grad(out, (*leaves, *lats), gy)
    want = torch.autograd.grad(ref, (*leaves, *lats), gy)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert float((a.float() - b.float()).norm() / b.float().norm()) <= 5e-2


@pytest.mark.parametrize("proj,dh,widths,legacy", [
    (False, 128, None, False),
    (False, 64, None, True),
    (False, 32, None, True),
    (True, 128, (128, 128, 256), False),
    (True, 128, (16, 32, 48), True),     # levels not multiples of 64
    (True, 64, (128, 128, 256), True),
])
def test_k7_fwd_legacy_counter_moves_only_off_the_plan(dev, proj, dh, widths, legacy):
    """The legacy kernel runs exactly where fwd_plan says: d_hidden other than
    128, or latent levels the wgmma kernel does not take; both kernels agree
    with the plain version."""
    from neural_jacobian_field_torch.ops.kernels import field_mlp

    n, d_out = 1000, 16
    if proj:
        params, cfg, lat, x, _ = _k7_exact_case(dev, n, dh, 3, 3, d_out, widths, 32)
        wrapper, plain = K.fused_resnet_fc, K.fused_resnet_fc_plain
    else:
        params, cfg, lat, x, _ = _k7_case(dev, n, dh, 3, 3, d_out, 32)
        wrapper, plain = K.fused_resnet_fc_tz, K.fused_resnet_fc_tz_plain
    plan = field_mlp.fwd_plan(n, 63, dh, 3, 3, d_out, widths)
    assert plan.legacy == legacy
    l0 = wrapper.legacy_launches
    got = wrapper(params, cfg, lat, x, d_out)
    torch.cuda.synchronize()
    assert wrapper.legacy_launches - l0 == int(legacy)
    want = plain(params, cfg, lat, x, d_out)
    assert (got - want).abs().max() <= 1e-2 * want.abs().max()


# ------------------------------------ K7-bwd / K7-tz-bwd: the wgmma passes

_K7_BWD_WG = [  # (projection mode, n, n_blocks, combine, d_out, latent widths)
    (False, 50, 5, 3, 24, None),               # fewer points than one tile
    (False, 4099, 5, 3, 1, None),              # ragged tile, the proposal trunk
    (False, 65537, 5, 3, 16, None),            # one point past a tile
    (False, 4099, 5, 0, 24, None),             # no injection
    (False, 4099, 0, 3, 16, None),             # lin_in and lin_out only
    (False, 263169, 5, 3, 24, None),           # crosses the 2^18-point chunk
    (True, 50, 5, 3, 1, (128, 128, 256)),
    (True, 4099, 5, 3, 24, (128, 128, 256)),   # the f32 coarse level
    (True, 65537, 5, 3, 16, (128, 128, 256)),
    (True, 4099, 5, 0, 16, (128, 128, 256)),
    (True, 4099, 5, 3, 16, (512,)),            # one bf16 level
    (True, 263169, 5, 3, 1, (128, 128, 256)),  # crosses the chunk
]


def _seq(t):
    return t if isinstance(t, tuple) else (t,)


def _leaf_err(grads, want, fn):
    """The worst leaf of grads against want under fn."""
    return max(fn(grads[k][leaf], v) for k, p in want.items() for leaf, v in p.items())


def _l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


def _bwd_errors(grads, dlat, pgrads, pdlat, levels, max_tol=2e-2, l2_tol=1e-2):
    """Asserts the K7 backward bounds: every dW/db leaf finite, within
    max_tol of its scale and l2_tol in l2; dtz / each level's dz, in its
    dtype, within 1e-2 in l2 and at most 1e-3 of its elements further than
    2e-2 of scale."""
    assert set(grads) == set(pgrads)
    for layer, leaves in pgrads.items():
        assert set(grads[layer]) == set(leaves), layer
        for leaf, want in leaves.items():
            got = grads[layer][leaf]
            assert got.dtype == torch.float32 and got.shape == want.shape, (layer, leaf)
            assert bool(torch.isfinite(got).all()), (layer, leaf)
            assert _rel(got, want) <= max_tol, (layer, leaf, _rel(got, want))
            assert _l2(got, want) <= l2_tol, (layer, leaf, _l2(got, want))
    for lvl, a, b in zip(levels, dlat, pdlat):
        assert a.dtype == lvl.dtype and a.shape == lvl.shape
        if not b.numel() or not b.float().abs().max():
            assert not a.numel() or not a.float().abs().max()
            continue
        err = (a.float() - b.float()).abs()
        assert float(err.norm() / b.float().norm()) <= 1e-2
        assert float((err > 2e-2 * b.float().abs().max()).float().mean()) <= 1e-3


@pytest.mark.parametrize("proj,n,n_blocks,combine,d_out,widths", _K7_BWD_WG)
def test_k7_bwd_wgmma_matches_plain_and_repeats(dev, monkeypatch, proj, n, n_blocks, combine,
                                                d_out, widths):
    """The two wgmma passes (d_hidden 128) against the legacy kernel on the
    same inputs, which recomputes the same bf16 forward (so the same ReLU
    masks) and sums the same float32 products in another order: every leaf
    within 1e-4 of its scale, dtz / dz within 1e-3 in l2. Against the plain
    backward: the legacy tests' bounds (2e-2 of scale, 1e-2 in l2), or the
    legacy kernel's own distance from the plain version on these inputs
    plus 1e-4 of scale, where that is larger: the plain version sums in
    another order, which can round a recomputed bf16 activation the other
    way and so move a ReLU mask, in both kernels alike (a few 1e-2 of
    scale at 4,099 points on an H100). No launch reaches the legacy
    kernel, and two calls give identical bits (split-K partials and bias
    sums added in a fixed order, no atomics)."""
    from neural_jacobian_field_torch.ops.kernels import field_mlp

    if proj:
        params, cfg, lat, x, gy = _k7_exact_case(dev, n, 128, n_blocks, combine, d_out, widths, 40)
        wrapper, plain = K.fused_resnet_fc_bwd, K.fused_resnet_fc_bwd_plain
    else:
        params, cfg, lat, x, gy = _k7_case(dev, n, 128, n_blocks, combine, d_out, 40)
        wrapper, plain = K.fused_resnet_fc_tz_bwd, K.fused_resnet_fc_tz_bwd_plain
    plan = field_mlp.bwd_plan(n, 63, 128, n_blocks, min(combine, n_blocks), d_out, widths)
    assert not plan.legacy
    n0, l0 = wrapper.launches, wrapper.legacy_launches
    grads, dlat = wrapper(params, cfg, lat, x, gy, d_out)
    again, dagain = wrapper(params, cfg, lat, x, gy, d_out)
    torch.cuda.synchronize()
    assert (wrapper.launches - n0, wrapper.legacy_launches - l0) == (2, 0)
    for layer, leaves in grads.items():
        for leaf, v in leaves.items():
            assert torch.equal(again[layer][leaf], v), (layer, leaf)
    for a, b in zip(_seq(dlat), _seq(dagain)):
        assert torch.equal(a, b)
    levels = _seq(lat)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    legacy = field_mlp.legacy_bwd_plan(n, sms)
    monkeypatch.setattr(field_mlp, "bwd_plan", lambda *a, **k: legacy)
    lgrads, ldlat = wrapper(params, cfg, lat, x, gy, d_out)
    monkeypatch.undo()
    assert wrapper.legacy_launches - l0 == 1
    assert _leaf_err(grads, lgrads, _rel) <= 1e-4
    for a, b in zip(_seq(dlat), _seq(ldlat)):
        assert not b.numel() or _l2(a, b) <= 1e-3

    pgrads, pdlat = plain(params, cfg, lat, x, gy, d_out)
    _bwd_errors(grads, _seq(dlat), pgrads, _seq(pdlat), levels,
                max(2e-2, _leaf_err(lgrads, pgrads, _rel) + 1e-4),
                max(1e-2, _leaf_err(lgrads, pgrads, _l2) + 1e-4))


@pytest.mark.parametrize("proj", [False, True])
def test_k7_functions_backward_through_wgmma(dev, proj):
    """fused_resnet_fc_train{,_tz} at d_hidden 128: autograd's backward runs
    the wgmma passes (one launch, no legacy one) and hands every leaf and
    the latent exactly what the backward wrapper gives for the same inputs
    (the passes are deterministic)."""
    widths = (128, 128, 256) if proj else None
    bwd = K.fused_resnet_fc_bwd if proj else K.fused_resnet_fc_tz_bwd
    _, _, params, cfg, lat, x, gy = _k7_wg_case(dev, proj, 4099, 5, 3, 24, widths, 41)
    from neural_jacobian_field_torch.ops.kernels.field_mlp import _leaf_names

    names = _leaf_names(cfg, not proj)
    want, wlat = bwd(params, cfg, lat, x, gy, 24)
    leaves = [params[layer][leaf].requires_grad_() for layer, leaf in names]
    lats = list(lat) if proj else [lat]
    for t in lats:
        t.requires_grad_()
    fn = K.fused_resnet_fc_train if proj else K.fused_resnet_fc_train_tz
    out = fn(params, cfg, lat, x, 24)
    n0, l0 = bwd.launches, bwd.legacy_launches
    got = torch.autograd.grad(out, (*leaves, *lats), gy)
    torch.cuda.synchronize()
    assert (bwd.launches - n0, bwd.legacy_launches - l0) == (1, 0)
    for (layer, leaf), a in zip(names, got[:len(names)]):
        assert torch.equal(a, want[layer][leaf]), (layer, leaf)
    for a, b in zip(got[len(names):], _seq(wlat)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("proj,dh,widths,legacy", [
    (False, 128, None, False),
    (False, 64, None, True),
    (True, 128, (128, 128, 256), False),
    (True, 128, (16, 32, 48), True),     # levels not multiples of 64
    (True, 32, (64,), True),
])
def test_k7_bwd_legacy_counter_moves_only_off_the_plan(dev, monkeypatch, proj, dh, widths,
                                                       legacy):
    """The legacy backward runs exactly where bwd_plan says. The legacy
    kernel agrees with the plain version (the legacy tests' bounds); the
    wgmma passes agree with the legacy kernel forced onto the same inputs
    (1e-4 of scale: the same recompute, float32 sums reordered)."""
    from neural_jacobian_field_torch.ops.kernels import field_mlp

    n, d_out = 1000, 16
    if proj:
        params, cfg, lat, x, gy = _k7_exact_case(dev, n, dh, 3, 3, d_out, widths, 42)
        wrapper, plain = K.fused_resnet_fc_bwd, K.fused_resnet_fc_bwd_plain
    else:
        params, cfg, lat, x, gy = _k7_case(dev, n, dh, 3, 3, d_out, 42)
        wrapper, plain = K.fused_resnet_fc_tz_bwd, K.fused_resnet_fc_tz_bwd_plain
    plan = field_mlp.bwd_plan(n, 63, dh, 3, 3, d_out, widths)
    assert plan.legacy == legacy
    l0 = wrapper.legacy_launches
    grads, dlat = wrapper(params, cfg, lat, x, gy, d_out)
    torch.cuda.synchronize()
    assert wrapper.legacy_launches - l0 == int(legacy)
    if legacy:
        pgrads, pdlat = plain(params, cfg, lat, x, gy, d_out)
        _bwd_errors(grads, _seq(dlat), pgrads, _seq(pdlat), _seq(lat))
        return
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    monkeypatch.setattr(field_mlp, "bwd_plan", lambda *a, **k: field_mlp.legacy_bwd_plan(n, sms))
    lgrads, ldlat = wrapper(params, cfg, lat, x, gy, d_out)
    assert _leaf_err(grads, lgrads, _rel) <= 1e-4
    for a, b in zip(_seq(dlat), _seq(ldlat)):
        assert _l2(a, b) <= 1e-3


# ---------------------------------- the serving entry points as CUDA graphs

def _serving_model(dev, mode):
    """A small bf16 flagship-shaped model (ResNet-34 at full width, trunks of
    2 x 128 so that K7 runs its wgmma kernels, 16 + 16 samples) in the given
    feature mode, seeded weights with the Jacobian head at the density
    head's scale."""
    from dataclasses import replace

    from neural_jacobian_field_torch.models.decoders import ActionDecoderJacobianMlpCfg
    from neural_jacobian_field_torch.models.decoders import DensityDecoderMlpCfg
    from neural_jacobian_field_torch.models.model import Model, flagship_model_cfg
    from neural_jacobian_field_torch.models.resnet_fc import MlpCfg

    mlp = MlpCfg(n_blocks=2, d_hidden=128, combine_layer=3)
    cfg = flagship_model_cfg(pixel_feature_mode=mode, num_proposal_samples=(16,),
                             num_nerf_samples=16, epipolar_knots=(16, 8, 4))
    cfg = replace(cfg, density_decoder=DensityDecoderMlpCfg(mlp=mlp),
                  action_decoder=ActionDecoderJacobianMlpCfg(mlp=mlp))
    g = torch.Generator().manual_seed(0)
    model = Model(cfg, compute_dtype=torch.bfloat16).init_weights(g)
    head = model.decoder.jacobian_head
    head.near_zero_init = False
    head.init_weights(g)
    return model.to(dev).eval()


def _serving_scene(dev, seed=0, deg=10.0, rays=96):
    from neural_jacobian_field_torch.inference.render import camera_rays
    from neural_jacobian_field_torch.models.model import CameraInput, RenderingInput, RobotInput

    g = _gen(seed)
    t = math.radians(deg)
    trgt = torch.eye(4, device=dev)
    trgt[0, 0], trgt[0, 2], trgt[2, 0], trgt[2, 2] = math.cos(t), math.sin(t), -math.sin(t), \
        math.cos(t)
    trgt[:3, 3] = torch.tensor([0.0, 0.0, 2.0], device=dev) - trgt[:3, :3] @ torch.tensor(
        [0.0, 0.0, 2.0], device=dev)
    intr = torch.tensor([[[1.2, 0.0, 0.5], [0.0, 1.6, 0.5], [0.0, 0.0, 1.0]]], device=dev)
    cam = CameraInput(input_image=torch.rand((1, 64, 96, 3), generator=g, device=dev),
                      ctxt_extrinsics=torch.eye(4, device=dev)[None], ctxt_intrinsics=intr,
                      trgt_extrinsics=trgt[None], trgt_intrinsics=intr)
    origins, dirs = camera_rays(8, 12, intr, trgt[None])
    ri = RenderingInput(origins=origins[:, :rays], directions=dirs[:, :rays],
                        z_near=torch.full((1,), 0.5, device=dev),
                        z_far=torch.full((1,), 4.0, device=dev))
    robot = RobotInput(0.1 * torch.randn((1, 8), generator=g, device=dev))
    return cam, ri, robot


def _serve(model, cam, ri, robot):
    """Every serving entry point once: render, encoder, encode_image, the
    Adam solve and the least-squares solve; all outputs, flat."""
    from neural_jacobian_field_torch.inference.action_opt import (
        optimize_actions, solve_actions_least_squares)
    from neural_jacobian_field_torch.inference.render import render_camera
    from neural_jacobian_field_torch.models.model import RobotInput

    out = list(vars(render_camera(model, cam, robot, 0.5, 4.0, 8, 12, patch_size=32)).values())
    with torch.no_grad():
        pe = model.compute_pixel_encoding(cam, robot)
    out += [pe.features.fine2, pe.features.mid2, pe.features.coarse]
    enc = model.encode_image(cam, ri, robot)
    out += [enc.density, enc.action_features, enc.weights, enc.ray_samples_positions]
    with torch.no_grad():
        target = model.infer_optical_flow(enc, cam, RobotInput(0.2 * robot.robot_action))
    a0 = torch.full((1, 8), 1e-3, device=cam.input_image.device)
    out += list(optimize_actions(model, enc, cam, target, action0=a0, num_iters=20))
    out.append(solve_actions_least_squares(model, enc, cam, target))
    return out


def _same_bits(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and torch.equal(g, w), i


@pytest.mark.parametrize("mode", ["epipolar", "exact"])
def test_captured_serving_is_eager_serving(dev, mode):
    """Render (3 chunks), encoder, encode_image and both solvers through their
    five CUDA graphs (the render's encoder is compute_pixel_encoding's) equal the eager calls bit for bit (the same kernels on the
    same inputs in the same order), repeat bit for bit, and count the
    launches the eager calls count."""
    model = _serving_model(dev, mode)
    cam, ri, robot = _serving_scene(dev)
    with model.programs.eager():
        K.reset_launch_counts()
        want = _serve(model, cam, ri, robot)
        eager_counts = K.launch_counts()
    assert len(model.programs) == 0
    _serve(model, cam, ri, robot)  # captures every program
    assert len(model.programs) == 5
    K.reset_launch_counts()
    got = _serve(model, cam, ri, robot)
    assert K.launch_counts() == eager_counts
    _same_bits(got, want)
    _same_bits(_serve(model, cam, ri, robot), got)


@pytest.mark.parametrize("mode", ["epipolar", "exact"])
def test_captured_serving_follows_new_inputs_and_weights(dev, mode):
    """Replays on a new image, a shifted camera and a new action; then on
    weights loaded in place (the same programs) and on weights reassigned
    (captured again): each equal to the eager calls on the same inputs."""
    model = _serving_model(dev, mode)
    _serve(model, *_serving_scene(dev))
    programs = list(model.programs)
    scene = _serving_scene(dev, seed=1, deg=14.0)
    got = _serve(model, *scene)
    with model.programs.eager():
        _same_bits(got, _serve(model, *scene))
    other = _serving_model(dev, mode)
    with torch.no_grad():
        for p in other.parameters():
            p.mul_(1.1)
    model.load_state_dict(other.state_dict())  # in place
    got = _serve(model, *scene)
    assert list(model.programs) == programs
    with model.programs.eager():
        _same_bits(got, _serve(model, *scene))
    model.load_state_dict({k: v.clone() for k, v in other.state_dict().items()},
                          assign=True)  # reassigned
    got = _serve(model, *scene)
    assert len(model.programs) == 5
    assert not any(p in programs for p in model.programs)
    with model.programs.eager():
        _same_bits(got, _serve(model, *scene))


@pytest.mark.parametrize("mode", ["epipolar", "exact"])
def test_serving_capture_waits_on_no_host_sync(dev, mode):
    """Every program is captured, and replayed, with CUDA's sync debug mode
    raising on any operation that would wait for the device."""
    model = _serving_model(dev, mode)
    scene = _serving_scene(dev)
    _serve(model, *scene)  # the kernels built and loaded, cuBLAS initialised
    model.programs = type(model.programs)()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            out = _serve(model, *scene)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(model.programs) == 5
    assert all(bool(torch.isfinite(t.float()).all()) for t in out)



# ------------------------------------------- the train steps as CUDA graphs

def _train_state(dev, mode, stage="perception"):
    """A train state of `_serving_model`'s model (trunks of 2 x 128, 16 + 16
    samples) in training: seeded weights, lr 5e-4, warmup 5; stage 2 trains
    the Jacobian head alone."""
    from neural_jacobian_field_torch.training import TrainCfg, create_train_state

    model = _serving_model(dev, mode)
    return create_train_state(model, TrainCfg(mode=stage, lr=5e-4, warm_up_steps=5,
                                              rays_per_batch=64))


def _train_batch(dev, stage="perception", seed=2, b=2):
    from neural_jacobian_field_torch.training import RawBatch

    g = _gen(seed)
    cam, _, _ = _serving_scene(dev, seed=seed)
    h, w = 64, 96
    batch = RawBatch(
        ctxt_rgb=torch.rand((b, h, w, 3), generator=g, device=dev),
        ctxt_extrinsics=cam.ctxt_extrinsics.expand(b, 4, 4),
        ctxt_intrinsics=cam.ctxt_intrinsics.expand(b, 3, 3),
        robot_action=0.1 * torch.randn((b, 8), generator=g, device=dev),
        trgt_rgb=torch.rand((b, h, w, 3), generator=g, device=dev),
        trgt_depth=1.0 + 2.0 * torch.rand((b, h, w, 1), generator=g, device=dev),
        trgt_extrinsics=cam.trgt_extrinsics.expand(b, 4, 4),
        trgt_intrinsics=cam.trgt_intrinsics.expand(b, 3, 3),
        near=torch.full((b,), 0.5, device=dev), far=torch.full((b,), 4.0, device=dev))
    if stage == "action":
        batch.flow = torch.randn((b, h, w, 2), generator=g, device=dev)
    return batch


def _train_calls(state, batch, randomness):
    """An update step, a frozen step and a 2-step call (False, True), each
    from make_train_step / make_multi_train_step with the given randomness;
    returns every metric."""
    from neural_jacobian_field_torch.training import (
        make_multi_train_step, make_train_step, stack_batches)

    model, cfg = state.model, state.cfg
    out = []
    for gate, (yx, draws) in zip((True, False), randomness[:2]):
        out += list(make_train_step(model, cfg, static_updated=gate)(
            state, batch, yx=yx, draws=draws).values())
    (y1, d1), (y2, d2) = randomness[2:]
    multi = make_multi_train_step(model, cfg, 2, static_schedule=(False, True))
    out += list(multi(state, stack_batches([batch, batch]), yx=torch.stack([y1, y2]),
                      draws=[torch.stack(ds) for ds in zip(d1, d2)]).values())
    return out


def _train_tensors(state):
    return ([p.detach() for p in state.model.parameters()] + list(state.model.buffers())
            + state.optimizer.state_tensors())


def _l2(x, y):
    return float((x.double() - y.double()).norm())


@pytest.mark.parametrize("mode,stage", [("epipolar", "perception"), ("exact", "perception"),
                                        ("epipolar", "action")])
def test_captured_train_program_is_the_eager_step(dev, mode, stage):
    """Four steps (update, frozen, and a 2-step program) through CUDA graphs
    and, from the same state and randomness, eagerly five times: metrics,
    parameters, BatchNorm statistics and Adam's state. Where the eager runs
    agree bit for bit (the first step's metrics; every tensor of a stage-2
    step, whose backward stays in the Jacobian trunk), the captured run
    equals them bit for bit; where they do not (a stage-1 backward sums with
    atomics: torch.gather's and the bilinear upsampling's), it is one more
    such run: its l2 distance to the nearest eager run over the eager runs'
    spread is at most 10 in every tensor and at most 1 in the median.
    Launches counted through replay equal the eager step's; a stage-1 step
    launches two trunks forward."""
    import itertools

    from neural_jacobian_field_torch.training import make_train_step, step_randomness

    batch = _train_batch(dev, stage)
    states = [_train_state(dev, mode, stage) for _ in range(6)]
    g = _gen(5)
    randomness = [step_randomness(states[0], batch, g) for _ in range(4)]
    runs = []
    for i, state in enumerate(states):
        context = state.model.programs.eager() if i < 5 else contextlib.nullcontext()
        with context:
            metrics = _train_calls(state, batch, randomness)
        torch.cuda.synchronize()
        runs.append([t.clone() for t in metrics + _train_tensors(state)])
    *eager, captured = runs
    assert all(torch.equal(a, c) for a, c in zip(eager[0][:11], captured[:11]))
    ratios = []
    for i, c in enumerate(captured):
        ts = [run[i] for run in eager]
        assert torch.isfinite(c.float()).all(), i
        if all(torch.equal(ts[0], t) for t in ts[1:]):
            assert torch.equal(c, ts[0]), i
        else:
            assert stage == "perception", i
            spread = max(_l2(x, y) for x, y in itertools.combinations(ts, 2))
            ratios.append(min(_l2(c, t) for t in ts) / spread)
    assert max(ratios, default=0.0) <= 10.0
    assert statistics.median(ratios or [0.0]) <= 1.0
    assert len(states[5].model.programs) == 3
    # launches through replay: the counts of an eager update step
    counts = {}
    for state in (states[0], states[5]):
        captures = state is states[5]
        with contextlib.nullcontext() if captures else state.model.programs.eager():
            torch.cuda.synchronize()
            K.reset_launch_counts()
            make_train_step(state.model, state.cfg, static_updated=True)(
                state, batch, yx=randomness[0][0], draws=randomness[0][1])
            torch.cuda.synchronize()
            counts[captures] = K.launch_counts()
    assert counts[True] == counts[False]
    trunk = "K7-tz-fwd" if mode == "epipolar" else "K7-fwd"
    assert counts[True][trunk] == (2 if stage == "perception" else 3)


@pytest.mark.parametrize("mode", ["epipolar", "exact"])
def test_train_program_capture_waits_on_no_host_sync(dev, mode):
    """The update, frozen and 2-step programs are captured, and replayed,
    with CUDA's sync debug mode raising on any operation that would wait
    for the device (the warm-up calls before each capture run eagerly under
    it too)."""
    from neural_jacobian_field_torch.training import step_randomness

    state = _train_state(dev, mode)
    batch = _train_batch(dev)
    g = _gen(6)
    with state.model.programs.eager():  # the kernels built, cuBLAS and cuDNN set up
        _train_calls(state, batch, [step_randomness(state, batch, g) for _ in range(4)])
    state.model.programs = type(state.model.programs)()
    randomness = [step_randomness(state, batch, g) for _ in range(4)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            out = _train_calls(state, batch, randomness)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(state.model.programs) == 3
    assert all(bool(torch.isfinite(t).all()) for t in out)
