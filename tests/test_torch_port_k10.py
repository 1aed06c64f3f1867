"""K10, the stride-1 3x3 conv with BatchNorm statistics, and the encoder under
conv_impl="pallas_fused", against the JAX package on the CPU.

The JAX side is `conv_suite.conv3x3_stats`, whose forward runs the Pallas
kernel `_s1_fwd_stats` in interpret mode here, and whose backward folds the
statistics' cotangents before the K9 pair. The port's side on the CPU is
K10's plain version under the `ConvS1Stats` Function. The encoder test uses
a 64x32 image, so that every stride-1 height (16, 8, 4) is on the Pallas
kernel's row-block family and JAX emits the statistics at all 24 convs, as
at the flagship's 480x640.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_jacobian_field_torch.ops.kernels import conv_suite
from neural_jacobian_field_torch.utils.from_jax import from_jax_variables

ENC_HW = (64, 32)


def _rel(got, want):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_k10_plain_and_function_match_pallas(dtype, tol):
    """y, s1, s2, and dx, dW under cotangents on all three outputs, against
    jax.vjp of conv3x3_stats. float32: the same float32 sums in other
    orders, 1e-5 of scale. bf16: y and the folded cotangent are rounded to
    bf16 once on each side, so one bf16 step of those moves the gradients:
    2e-2 of scale; s1 and s2 are float32 sums of the same exact products of
    bf16 inputs, 1e-5 of scale."""
    from neural_jacobian_field_tpu.ops.pallas import conv_suite as jk

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 12, 16)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 16, 24)) / 12.0).astype(np.float32)
    gy = rng.normal(size=(2, 8, 12, 24)).astype(np.float32)
    g1 = rng.normal(size=(24,)).astype(np.float32)
    g2 = (0.1 * rng.normal(size=(24,))).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    (jy, js1, js2), vjp = jax.vjp(jk.conv3x3_stats, jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    jdx, jdw = vjp((jnp.asarray(gy, jdt), jnp.asarray(g1), jnp.asarray(g2)))
    assert js1.dtype == jnp.float32

    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).to(tdt).requires_grad_()
    y, s1, s2 = conv_suite.conv_s1_stats(tx, tw)
    assert y.dtype == tdt and s1.dtype == s2.dtype == torch.float32
    assert y.grad_fn is not None
    dx, dw = torch.autograd.grad((y, s1, s2), (tx, tw),
                                 (torch.from_numpy(gy).to(tdt), torch.from_numpy(g1),
                                  torch.from_numpy(g2)))
    assert dx.dtype == dw.dtype == tdt
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    assert _rel(y, f32(jy)) <= (1e-5 if dtype == "float32" else 2 ** -7)
    assert _rel(s1, f32(js1)) <= 1e-5 and _rel(s2, f32(js2)) <= 1e-5
    assert _rel(dx, f32(jdx)) <= tol and _rel(dw, f32(jdw)) <= tol
    # y of the plain version is K9's plain forward, bit for bit
    py, _, _ = conv_suite.conv3x3_s1_stats_plain(tx.detach(), tw.detach())
    assert torch.equal(py, conv_suite.conv3x3_s1_plain(tx.detach(), tw.detach()))


def _jax_encoder(conv_impl):
    from neural_jacobian_field_tpu.models.encoder_resnet import EncoderResnet, EncoderResnetCfg

    return EncoderResnet(EncoderResnetCfg(norm_type="batch", feature_layout="pyramid",
                                          conv_impl=conv_impl))


def _port_encoder(conv_impl, variables):
    from neural_jacobian_field_torch.models.encoder_resnet import (
        EncoderResnet, EncoderResnetCfg)

    enc = EncoderResnet(EncoderResnetCfg(norm_type="batch", feature_layout="pyramid",
                                         conv_impl=conv_impl))
    enc.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"]),
                        strict=True)
    return enc


@pytest.fixture(scope="module")
def fused_encoder():
    """The JAX pallas_fused encoder in training mode on seeded weights and
    statistics: its output, new batch statistics and parameter gradients
    under seeded cotangents on the three pyramid levels."""
    from _torch_port_common import randomize_variables

    rng = np.random.default_rng(3)
    image = rng.uniform(size=(2, *ENC_HW, 3)).astype(np.float32)
    jenc = _jax_encoder("pallas_fused")
    variables = jax.tree.map(np.asarray, jenc.init(jax.random.PRNGKey(0), jnp.asarray(image)))
    variables = randomize_variables(variables, seed=4)
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])

    def f(p):
        pyr, new = jenc.apply({"params": p, "batch_stats": stats}, jnp.asarray(image),
                              train=True, mutable=["batch_stats"])
        return (pyr.fine, pyr.mid, pyr.coarse), new["batch_stats"]

    levels, vjp, new_stats = jax.vjp(f, jax.tree.map(jnp.asarray, variables["params"]),
                                     has_aux=True)
    cts = tuple(rng.normal(size=lv.shape).astype(np.float32) for lv in levels)
    (grads,) = vjp(tuple(jnp.asarray(c) for c in cts))
    return dict(image=image, variables=variables, levels=[np.asarray(v) for v in levels],
                new_stats=jax.tree.map(np.asarray, new_stats), cts=cts,
                grads=jax.tree.map(np.asarray, grads))


def test_pallas_fused_encoder_train_mode_matches_jax(fused_encoder):
    """The port's pallas_fused encoder in training mode, float32, from the
    same weights and statistics: every stride-1 3x3 conv goes through K10
    (24 calls), and the pyramid, the updated running statistics and every
    parameter's gradient agree with JAX's pallas_fused encoder (the same
    float32 sums in other orders: 1e-4 of scale for outputs and gradients,
    through 16 BatchNorms; 1e-5 for the statistics)."""
    ref = fused_encoder
    enc = _port_encoder("pallas_fused", ref["variables"])
    calls = []
    plain = conv_suite.conv3x3_s1_stats

    def counted(x, w):
        calls.append(tuple(x.shape))
        return plain(x, w)

    with mock.patch.object(conv_suite, "conv3x3_s1_stats", counted):
        pyr = enc(torch.from_numpy(ref["image"]), train=True)
    assert len(calls) == 24
    for got, want in zip((pyr.fine, pyr.mid, pyr.coarse), ref["levels"]):
        assert _rel(got, want) <= 1e-4
    want_stats = from_jax_variables({}, ref["new_stats"])
    bufs = dict(enc.named_buffers())
    for name, v in want_stats.items():
        assert _rel(bufs[name], v.numpy()) <= 1e-5, name
    loss = sum((lv * torch.from_numpy(c)).sum()
               for lv, c in zip((pyr.fine, pyr.mid, pyr.coarse), ref["cts"]))
    loss.backward()
    want = from_jax_variables(ref["grads"])
    for name, p in enc.named_parameters():
        assert _rel(p.grad, want[name].numpy()) <= 1e-4, (name, _rel(p.grad, want[name].numpy()))


def test_pallas_fused_encoder_eval_mode_is_pallas(fused_encoder):
    """In eval mode pallas_fused computes exactly what pallas does: no K10
    call, equal bits."""
    v = fused_encoder["variables"]
    image = torch.from_numpy(fused_encoder["image"])
    fused, pallas = _port_encoder("pallas_fused", v), _port_encoder("pallas", v)
    with mock.patch.object(conv_suite, "conv3x3_s1_stats", side_effect=AssertionError):
        with torch.no_grad():
            a, b = fused(image), pallas(image)
    for x, y in zip((a.fine, a.mid, a.coarse), (b.fine, b.mid, b.coarse)):
        assert torch.equal(x, y)
