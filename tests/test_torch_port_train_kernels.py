"""The backward kernels' plain versions (K9-dgrad, K9-wgrad, K6-bwd,
K7-tz-bwd) and the autograd.Functions around them, against the JAX package's
custom_vjps and Pallas kernels run in interpret mode on the CPU, same numpy
inputs. On a CPU tensor each wrapper takes exactly its plain version.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_jacobian_field_torch.ops import kernels as K


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------- K9 backward

@pytest.mark.parametrize("shape,cout", [((2, 10, 7, 8), 12), ((1, 8, 12, 16), 16)])
def test_k9_function_backward_matches_jax_vjp(shape, cout):
    """dx and dW of conv_s1 against jax.vjp of conv_suite.conv3x3 (K9-fwd on
    the rotated weights and K9-wgrad, interpret mode), float32: the same
    products summed in another order, 1e-5 of scale."""
    from neural_jacobian_field_tpu.ops.pallas.conv_suite import conv3x3

    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(3, 3, shape[-1], cout)) / math.sqrt(9 * shape[-1])).astype(np.float32)
    g = rng.normal(size=(*shape[:3], cout)).astype(np.float32)
    y, vjp = jax.vjp(conv3x3, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))

    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    ty = K.conv_s1(tx, tw)
    assert ty.grad_fn is not None
    got_dx, got_dw = torch.autograd.grad(ty, (tx, tw), _t(g))
    assert _rel(_np(ty), y) <= 1e-5
    assert _rel(_np(got_dx), want_dx) <= 1e-5
    assert _rel(_np(got_dw), want_dw) <= 1e-5
    assert torch.equal(got_dx, K.conv3x3_s1_dgrad_plain(_t(g), _t(w)))
    assert torch.equal(K.conv3x3_s1_dgrad(_t(g), _t(w)), got_dx)


@pytest.mark.parametrize("shape,cout,dtype", [
    ((2, 10, 8, 16), 16, "float32"),
    ((1, 8, 12, 8), 24, "bfloat16"),   # the working type, Cout != C
])
def test_k9_wgrad_plain_matches_pallas_s1_wgrad(shape, cout, dtype):
    """dW in float32 from the same (bf16-exact) products, summed in another
    order: 1e-5 of scale."""
    from neural_jacobian_field_tpu.ops.pallas.conv_suite import _s1_wgrad

    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=(*shape[:3], cout)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = np.asarray(_s1_wgrad(jnp.asarray(x, jdt), jnp.asarray(g, jdt), interpret=True))
    got = K.conv3x3_s1_wgrad_plain(_t(x, tdt), _t(g, tdt))
    assert got.dtype == torch.float32 and got.shape == (3, 3, shape[-1], cout)
    assert _rel(_np(got), want) <= 1e-5
    assert torch.equal(K.conv3x3_s1_wgrad(_t(x, tdt), _t(g, tdt)), got)


# ---------------------------------------------------------------- K6 backward

@pytest.mark.parametrize("shape", [(2, 5, 7, 8), (1, 3, 9, 16), (1, 1, 5, 4)])
def test_k6_bwd_plain_matches_pallas_pack_bwd(shape):
    """Odd H and W, so the last row's and column's border duplicates fold
    back: the same float32 additions in the same order, bit-exact."""
    from neural_jacobian_field_tpu.ops.pallas.pack2x2 import _pack_bwd_pallas

    b, h, w, c = shape
    g = np.random.default_rng(2).normal(size=(b, h * w, 4 * c)).astype(np.float32)
    want = np.asarray(_pack_bwd_pallas(jnp.asarray(g), h, interpret=True))
    got = K.pack_2x2_flat_bwd_plain(_t(g), h)
    np.testing.assert_array_equal(_np(got), want)
    assert torch.equal(K.pack_2x2_flat_bwd(_t(g), h), got)


def test_k6_function_backward_matches_jax_vjp():
    """pack_2x2_flat_train's gradient against jax.vjp of the JAX pack
    (its XLA fold off the TPU): float32 sums in another order, 1e-6."""
    from neural_jacobian_field_tpu.ops.pallas.pack2x2 import pack_2x2_flat

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 7, 8)).astype(np.float32)
    g = rng.normal(size=(2, 35, 32)).astype(np.float32)
    _, vjp = jax.vjp(pack_2x2_flat, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    tx = _t(x).requires_grad_()
    out = K.pack_2x2_flat_train(tx)
    assert out.grad_fn is not None
    (got,) = torch.autograd.grad(out, tx, _t(g))
    assert _rel(_np(got), want) <= 1e-6


# ------------------------------------------------------------- K7-tz backward

def _trunk_params(rng, d_in, dh, n_blocks, n_lin_z, d_out):
    def lin(din, dout):
        return {"kernel": (rng.normal(size=(din, dout)) / math.sqrt(din)).astype(np.float32),
                "bias": (0.1 * rng.normal(size=(dout,))).astype(np.float32)}

    p = {"lin_in": lin(d_in, dh)}
    for i in range(n_lin_z):
        p[f"lin_z_{i}"] = {"bias": lin(8, dh)["bias"]}
    for i in range(n_blocks):
        p[f"blocks_{i}_fc_0"] = lin(dh, dh)
        p[f"blocks_{i}_fc_1"] = lin(dh, dh)
    p["lin_out"] = lin(dh, d_out)
    return p


@pytest.mark.parametrize("d_out,n_blocks,combine", [(16, 2, 3), (1, 2, 1), (24, 3, 2)])
def test_k7tz_bwd_plain_matches_pallas_tz_bwd(d_out, n_blocks, combine):
    """Every dparams leaf and dtz against jax.vjp of fused_resnet_fc_train_tz
    (interpret mode) at bf16, n not a tile multiple, d_in = 63. Both recompute
    the same bf16 forward, keep dx and dW in float32 and round the operands
    of each product to bf16; only the accumulation order differs, which can
    round a bf16 value the other way (measured: at most 7e-5 of a leaf's
    scale): 1e-3 of each leaf's scale. x gets no gradient, and the
    autograd.Function gives the same leaves."""
    from neural_jacobian_field_tpu.models.resnet_fc import MlpCfg as JMlp
    from neural_jacobian_field_tpu.ops.pallas.field_mlp_train import fused_resnet_fc_train_tz
    from neural_jacobian_field_torch.models.resnet_fc import MlpCfg

    rng = np.random.default_rng(4)
    dh, n, d_in = 32, 300, 63
    n_lin_z = min(combine, n_blocks)
    params = _trunk_params(rng, d_in, dh, n_blocks, n_lin_z, d_out)
    tz = rng.normal(size=(n, n_lin_z * dh)).astype(np.float32)
    x = rng.uniform(-1, 1, size=(n, d_in)).astype(np.float32)
    g = rng.normal(size=(n, d_out)).astype(np.float32)
    jcfg = JMlp(n_blocks=n_blocks, d_hidden=dh, combine_layer=combine)
    jx = jnp.asarray(x, jnp.bfloat16)
    _, vjp = jax.vjp(lambda p, z: fused_resnet_fc_train_tz(p, jcfg, z, jx, d_out, True),
                     jax.tree.map(jnp.asarray, params), jnp.asarray(tz, jnp.bfloat16))
    want_p, want_tz = vjp(jnp.asarray(g))

    cfg = MlpCfg(n_blocks=n_blocks, d_hidden=dh, combine_layer=combine)
    tparams = jax.tree.map(torch.from_numpy, params)
    ttz, tx = _t(tz, torch.bfloat16), _t(x, torch.bfloat16)
    got_p, got_tz = K.fused_resnet_fc_tz_bwd_plain(tparams, cfg, ttz, tx, _t(g), d_out)
    assert got_tz.dtype == torch.bfloat16 and got_tz.shape == (n, n_lin_z * dh)
    if n_lin_z:
        assert _rel(_np(got_tz), np.asarray(want_tz, np.float32)) <= 1e-3
    assert set(got_p) == set(want_p)
    for layer, leaves in want_p.items():
        assert set(got_p[layer]) == set(leaves), layer
        for leaf, want in leaves.items():
            got = got_p[layer][leaf]
            assert got.dtype == torch.float32, (layer, leaf)
            assert _rel(_np(got), np.asarray(want)) <= 1e-3, (layer, leaf)

    # the autograd.Function: the same leaves, tz's gradient, none for x
    leaves = {(k, leaf): v.clone().requires_grad_() for k, p in tparams.items()
              for leaf, v in p.items()}
    fparams = {}
    for (k, leaf), v in leaves.items():
        fparams.setdefault(k, {})[leaf] = v
    ftz, fx = ttz.clone().requires_grad_(), tx.clone().requires_grad_()
    out = K.fused_resnet_fc_train_tz(fparams, cfg, ftz, fx, d_out)
    assert out.grad_fn is not None
    out.backward(_t(g))
    assert fx.grad is None
    for (k, leaf), v in leaves.items():
        assert torch.equal(v.grad, got_p[k][leaf]), (k, leaf)
    assert torch.equal(ftz.grad, got_tz)
