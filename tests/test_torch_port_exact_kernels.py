"""The exact feature path's kernels, by their plain versions, against the JAX
package: K1-fwd / K1-bwd (the coarse level's bilinear gather and its
scatter) against the Pallas kernels in interpret mode, and K7-fwd / K7-bwd
(the trunk that projects the latent itself) against `fused_resnet_fc_train`
in interpret mode and its jax.vjp. Same numpy inputs on both sides; on a CPU
tensor each wrapper takes exactly its plain version.
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


def _corners(rng, b, n, hc, wc):
    """Corner ids and weights as the JAX package's _corner_ids makes them,
    from random coordinates that also fall outside the map (clamped)."""
    from neural_jacobian_field_tpu.ops.pixel_gather import _corner_ids

    cx = rng.uniform(-2, wc + 1, size=(b, n)).astype(np.float32)
    cy = rng.uniform(-2, hc + 1, size=(b, n)).astype(np.float32)
    idx, w4 = _corner_ids(jnp.asarray(cx), jnp.asarray(cy), wc, hc)
    return np.array(idx), np.array(w4)


# ------------------------------------------------------------------------ K1

@pytest.mark.parametrize("b,n,hc,wc,c,dtype", [
    (2, 1500, 5, 7, 24, "float32"),    # N not a multiple of 1024, K = 35
    (1, 700, 6, 9, 16, "bfloat16"),    # the working type, K = 54
    (2, 64, 2, 3, 8, "bfloat16"),      # the test model's 2x3 coarse level
])
def test_k1_fwd_plain_matches_pallas(b, n, hc, wc, c, dtype):
    """out = sum of the four rounded weights times their texels: the same
    float32 products, summed by the one-hot matmul with zeros in between:
    1e-5 of scale."""
    from neural_jacobian_field_tpu.ops.pallas.onehot_gather import onehot_gather_fwd_pallas

    rng = np.random.default_rng(0)
    idx, w4 = _corners(rng, b, n, hc, wc)
    flat = rng.normal(size=(b, hc * wc, c)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    want = onehot_gather_fwd_pallas(jnp.asarray(flat, jdt), jnp.asarray(idx), jnp.asarray(w4),
                                    interpret=True)
    got = K.onehot_gather_fwd_plain(_t(flat, tdt), torch.from_numpy(idx).long(), _t(w4))
    assert got.dtype == torch.float32 and got.shape == (b, n, c)
    assert _rel(_np(got), want) <= 1e-5
    assert torch.equal(K.onehot_gather_fwd(_t(flat, tdt), torch.from_numpy(idx).long(),
                                           _t(w4)), got)


@pytest.mark.parametrize("b,n,hc,wc,c,dtype", [
    (2, 1500, 5, 7, 24, "float32"),
    (1, 2100, 6, 9, 16, "bfloat16"),
    (2, 64, 2, 3, 8, "bfloat16"),
])
def test_k1_bwd_plain_matches_pallas(b, n, hc, wc, c, dtype):
    """gF = onehot^T g: the same float32 products (weights rounded to g's
    dtype), summed over the points in another order: 1e-5 of scale."""
    from neural_jacobian_field_tpu.ops.pallas.onehot_gather import onehot_scatter_bwd_pallas

    rng = np.random.default_rng(1)
    idx, w4 = _corners(rng, b, n, hc, wc)
    g = rng.normal(size=(b, n, c)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    want = onehot_scatter_bwd_pallas(jnp.asarray(g, jdt), jnp.asarray(idx), jnp.asarray(w4),
                                     hc * wc, interpret=True)
    got = K.onehot_scatter_bwd_plain(_t(g, tdt), torch.from_numpy(idx).long(), _t(w4), hc * wc)
    assert got.dtype == torch.float32 and got.shape == (b, hc * wc, c)
    assert _rel(_np(got), want) <= 1e-5
    assert torch.equal(K.onehot_scatter_bwd(_t(g, tdt), torch.from_numpy(idx).long(), _t(w4),
                                            hc * wc), got)


# ------------------------------------------------------------------------ K7

def _trunk_params(rng, d_in, dh, n_blocks, n_lin_z, d_latent, d_out):
    def lin(din, dout):
        return {"kernel": (rng.normal(size=(din, dout)) / math.sqrt(din)).astype(np.float32),
                "bias": (0.1 * rng.normal(size=(dout,))).astype(np.float32)}

    p = {"lin_in": lin(d_in, dh)}
    for i in range(n_lin_z):
        p[f"lin_z_{i}"] = lin(d_latent, dh)
    for i in range(n_blocks):
        p[f"blocks_{i}_fc_0"] = lin(dh, dh)
        p[f"blocks_{i}_fc_1"] = lin(dh, dh)
    p["lin_out"] = lin(dh, d_out)
    return p


# (latent level widths and dtypes: one array, or the pyramid's three levels
# with the coarse one in float32 as K1-fwd gives it), d_out, blocks, combine
_K7_CASES = [
    (((64, "bfloat16"),), 16, 2, 3),
    (((16, "bfloat16"), (16, "bfloat16"), (32, "float32")), 1, 2, 3),
    (((16, "bfloat16"), (16, "bfloat16"), (32, "float32")), 24, 3, 2),
    (((48, "float32"),), 16, 2, 0),    # no latent injection
]


def _k7_inputs(levels, d_out, n_blocks, combine, n=300, dh=32, d_in=63, seed=4):
    rng = np.random.default_rng(seed)
    d_lat = sum(w for w, _ in levels)
    n_lin_z = min(combine, n_blocks)
    params = _trunk_params(rng, d_in, dh, n_blocks, n_lin_z, d_lat, d_out)
    zs = [rng.normal(size=(n, w)).astype(np.float32) for w, _ in levels]
    x = rng.uniform(-1, 1, size=(n, d_in)).astype(np.float32)
    g = rng.normal(size=(n, d_out)).astype(np.float32)
    return params, zs, x, g, dh


def _jax_z(zs, levels):
    out = tuple(jnp.asarray(z, jnp.float32 if d == "float32" else jnp.bfloat16)
                for z, (_, d) in zip(zs, levels))
    return out if len(out) > 1 else out[0]


def _torch_z(zs, levels):
    out = tuple(_t(z, torch.float32 if d == "float32" else torch.bfloat16)
                for z, (_, d) in zip(zs, levels))
    return out if len(out) > 1 else out[0]


@pytest.mark.parametrize("levels,d_out,n_blocks,combine", _K7_CASES)
def test_k7_fwd_plain_matches_pallas(levels, d_out, n_blocks, combine):
    """The same bf16 operands and per-layer roundings; the float32 sums run
    in another order, which could round a bf16 activation the other way and
    carry it (measured: at most 1.4e-7 of scale): 1e-3 of scale."""
    from neural_jacobian_field_tpu.models.resnet_fc import MlpCfg as JMlp
    from neural_jacobian_field_tpu.ops.pallas.field_mlp_train import fused_resnet_fc_train
    from neural_jacobian_field_torch.models.resnet_fc import MlpCfg

    params, zs, x, _, dh = _k7_inputs(levels, d_out, n_blocks, combine)
    jcfg = JMlp(n_blocks=n_blocks, d_hidden=dh, combine_layer=combine)
    want = np.asarray(fused_resnet_fc_train(jax.tree.map(jnp.asarray, params), jcfg,
                                            _jax_z(zs, levels), jnp.asarray(x, jnp.bfloat16),
                                            d_out, True))
    cfg = MlpCfg(n_blocks=n_blocks, d_hidden=dh, combine_layer=combine)
    tparams = jax.tree.map(torch.from_numpy, params)
    got = K.fused_resnet_fc_plain(tparams, cfg, _torch_z(zs, levels), _t(x, torch.bfloat16),
                                  d_out)
    assert got.dtype == torch.float32 and got.shape == (x.shape[0], d_out)
    assert _rel(_np(got), want) <= 1e-3
    assert torch.equal(K.fused_resnet_fc(tparams, cfg, _torch_z(zs, levels),
                                         _t(x, torch.bfloat16), d_out), got)


@pytest.mark.parametrize("levels,d_out,n_blocks,combine", _K7_CASES)
def test_k7_bwd_plain_matches_pallas_vjp(levels, d_out, n_blocks, combine):
    """Every dparams leaf (the lin_z kernels included) and every level's dz
    against jax.vjp of fused_resnet_fc_train (interpret mode). Both
    recompute the same bf16 forward, keep dx and dW in float32 and round the
    operands of each product to bf16; only the accumulation order differs
    (measured: at most 4e-7 of a leaf's scale): 1e-3 of each leaf's scale. dz comes in each level's dtype; x gets no
    gradient, and the autograd.Function gives the same leaves."""
    from neural_jacobian_field_tpu.models.resnet_fc import MlpCfg as JMlp
    from neural_jacobian_field_tpu.ops.pallas.field_mlp_train import fused_resnet_fc_train
    from neural_jacobian_field_torch.models.resnet_fc import MlpCfg

    params, zs, x, g, dh = _k7_inputs(levels, d_out, n_blocks, combine)
    jcfg = JMlp(n_blocks=n_blocks, d_hidden=dh, combine_layer=combine)
    jx = jnp.asarray(x, jnp.bfloat16)
    _, vjp = jax.vjp(lambda p, z: fused_resnet_fc_train(p, jcfg, z, jx, d_out, True),
                     jax.tree.map(jnp.asarray, params), _jax_z(zs, levels))
    want_p, want_z = vjp(jnp.asarray(g))
    want_z = want_z if isinstance(want_z, tuple) else (want_z,)

    cfg = MlpCfg(n_blocks=n_blocks, d_hidden=dh, combine_layer=combine)
    tparams = jax.tree.map(torch.from_numpy, params)
    tz, tx = _torch_z(zs, levels), _t(x, torch.bfloat16)
    got_p, got_z = K.fused_resnet_fc_bwd_plain(tparams, cfg, tz, tx, _t(g), d_out)
    got_z = got_z if isinstance(got_z, tuple) else (got_z,)
    for gz, wz, (_, dtype) in zip(got_z, want_z, levels):
        assert str(gz.dtype).endswith(dtype) and gz.shape == wz.shape
        if np.abs(np.asarray(wz, np.float32)).max():
            assert _rel(_np(gz), np.asarray(wz, np.float32)) <= 1e-3
        else:
            assert not gz.abs().max()
    assert set(got_p) == set(want_p)
    for layer, leaves in want_p.items():
        assert set(got_p[layer]) == set(leaves), layer
        for leaf, want in leaves.items():
            got = got_p[layer][leaf]
            assert got.dtype == torch.float32, (layer, leaf)
            assert _rel(_np(got), np.asarray(want)) <= 1e-3, (layer, leaf)

    # the autograd.Function: the same leaves, every level's gradient, none for x
    leaves = {(k, leaf): v.clone().requires_grad_() for k, p in tparams.items()
              for leaf, v in p.items()}
    fparams = {}
    for (k, leaf), v in leaves.items():
        fparams.setdefault(k, {})[leaf] = v
    fz = tuple(t.clone().requires_grad_() for t in (tz if isinstance(tz, tuple) else (tz,)))
    fx = tx.clone().requires_grad_()
    out = K.fused_resnet_fc_train(fparams, cfg, fz if len(fz) > 1 else fz[0], fx, d_out)
    assert out.grad_fn is not None
    out.backward(_t(g))
    assert fx.grad is None
    for (k, leaf), v in leaves.items():
        assert torch.equal(v.grad, got_p[k][leaf]), (k, leaf)
    for t, gz in zip(fz, got_z):
        assert torch.equal(t.grad, gz)
