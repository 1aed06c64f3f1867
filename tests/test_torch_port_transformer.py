"""The port's transformer (models/transformer.py) and the encoder's group,
instance and no-norm settings against the JAX modules, in float32 on the
CPU, weights through the bridge (utils/from_jax.py).

Attention (cross and self), FeedForward and the Transformer stack at dim 16,
2 heads of 8, depth 2: outputs and the gradients of the inputs and of every
parameter agree to 1e-5 of scale (the same float32 matmuls, summed in
another order). The encoder (ResNet-34 in pyramid and concat layout at a
32x48 image) under each norm: 1e-4 of scale, as the BatchNorm encoder test
(tests/test_torch_port_encoder.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import IMAGE_HW, randomize_variables
from neural_jacobian_field_torch.utils.from_jax import from_jax_variables

DIM, HEADS, DIM_HEAD, DEPTH, MLP_DIM, KV_LEN = 16, 2, 8, 2, 16, 4
TOL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _modules(kind):
    """(JAX module, port module, whether it takes z) of one kind."""
    from neural_jacobian_field_tpu.models import transformer as jt
    from neural_jacobian_field_torch.models import transformer as tt

    if kind == "cross attention":
        return (jt.Attention(dim=DIM, heads=HEADS, dim_head=DIM_HEAD, selfatt=False,
                             kv_dim=DIM),
                tt.Attention(DIM, HEADS, DIM_HEAD, selfatt=False, kv_dim=DIM), True)
    if kind == "self attention":
        return (jt.Attention(dim=DIM, heads=HEADS, dim_head=DIM_HEAD),
                tt.Attention(DIM, HEADS, DIM_HEAD), False)
    if kind == "single head":  # heads 1, dim_head == dim: no output projection
        return (jt.Attention(dim=DIM, heads=1, dim_head=DIM),
                tt.Attention(DIM, 1, DIM), False)
    if kind == "feed forward":
        return jt.FeedForward(dim=DIM, hidden_dim=MLP_DIM), tt.FeedForward(DIM, MLP_DIM), None
    return (jt.Transformer(dim=DIM, depth=DEPTH, heads=HEADS, dim_head=DIM_HEAD,
                           mlp_dim=MLP_DIM, selfatt=False, kv_dim=DIM),
            tt.Transformer(DIM, DEPTH, HEADS, DIM_HEAD, MLP_DIM, selfatt=False, kv_dim=DIM),
            True)


@pytest.mark.parametrize("kind", ["cross attention", "self attention", "single head",
                                  "feed forward", "transformer"])
def test_transformer_modules_match_jax(kind):
    """Forward and backward of one module from the same random weights: x
    [2, 5, 16] tokens, z [1, 4, 16] keys and values broadcast over the batch
    (the decoder's index embedding); loss sum(out * c) for a random c."""
    jmod, tmod, takes_z = _modules(kind)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, DIM)).astype(np.float32)
    z = rng.normal(size=(1, KV_LEN, DIM)).astype(np.float32)
    args = (jnp.asarray(x),) + ((jnp.asarray(z),) if takes_z else ())
    params = randomize_variables(jax.tree.map(np.asarray,
                                              dict(jmod.init(jax.random.PRNGKey(0), *args))))
    c = rng.normal(size=jmod.apply(params, *args).shape).astype(np.float32)

    def loss(p, *a):
        return jnp.sum(jmod.apply(p, *a) * c)

    want = jmod.apply(params, *args)
    want_grads = jax.grad(loss, argnums=tuple(range(len(args) + 1)))(params, *args)

    tmod.load_state_dict(from_jax_variables(params["params"]), strict=True)
    tx = torch.from_numpy(x).requires_grad_()
    tz = torch.from_numpy(z).requires_grad_() if takes_z else None
    got = tmod(tx, tz) if takes_z is not None else tmod(tx)
    assert _rel(got.detach(), want) <= TOL
    (got * torch.from_numpy(c)).sum().backward()
    assert _rel(tx.grad, want_grads[1]) <= TOL
    if takes_z:
        assert _rel(tz.grad, want_grads[2]) <= TOL
    grads = from_jax_variables(jax.tree.map(np.asarray, want_grads[0]["params"]))
    assert set(grads) == {n for n, _ in tmod.named_parameters()}
    for name, p in tmod.named_parameters():
        assert _rel(p.grad, grads[name].numpy()) <= TOL, name


@pytest.mark.parametrize("keys", [6, 8])
def test_fused_bf16_transformer_matches_jax(keys):
    """The Jacobian decoder's bf16 transformer (dim 64, depth 3, 8 heads of
    64, mlp 64), which the port runs through the fused layer
    (ops/kernels/attn_layer.py; its plain version on the CPU), against the
    JAX module at compute_dtype bf16 from the same weights: x [1, 256, 64]
    float32, z [1, keys, 64] (the toy arm's 6 actions, allegro's 8).

    Limits from bf16 rounding (unit 2^-8): the JAX module rounds each dense
    product before adding its bias and rounds between GELU's steps, where
    the port rounds once; over 3 layers these give a few roundings of each
    branch, so the residual's change y - x is held to 2^-6 of its scale
    (measured at most 8.6e-3, the per-op module's own reading). JAX also
    rounds every gradient to bf16 along the chain where the fused backward
    keeps float32, so the input, key and parameter gradients are held to
    3e-2 (measured: dx at most 7.3e-3, dz 9.3e-3, the parameters 2.6e-2 at
    fc1's bias of the first layer with 6 keys, a column sum of JAX's bf16
    dh that the per-op module also reads 2.6e-2 from JAX)."""
    from neural_jacobian_field_tpu.models import transformer as jt
    from neural_jacobian_field_torch.models import transformer as tt

    jmod = jt.Transformer(dim=64, depth=3, heads=8, dim_head=64, mlp_dim=64, selfatt=False,
                          kv_dim=64, compute_dtype=jnp.bfloat16)
    tmod = tt.Transformer(64, 3, 8, 64, 64, selfatt=False, kv_dim=64,
                          compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(keys)
    x = rng.normal(size=(1, 256, 64)).astype(np.float32)
    z = rng.normal(size=(1, keys, 64)).astype(np.float32)
    params = randomize_variables(jax.tree.map(np.asarray, dict(
        jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(z)))))
    want = jmod.apply(params, x, z)
    assert want.dtype == jnp.float32
    c = rng.normal(size=want.shape).astype(np.float32)
    want_grads = jax.grad(lambda p, a, b: jnp.sum(jmod.apply(p, a, b) * c),
                          argnums=(0, 1, 2))(params, x, z)

    tmod.load_state_dict(from_jax_variables(params["params"]), strict=True)
    tx, tz = torch.from_numpy(x).requires_grad_(), torch.from_numpy(z).requires_grad_()
    assert tmod._fused(tx, tz)
    got = tmod(tx, tz)
    assert _rel(got.detach() - tx.detach(), np.asarray(want) - x) <= 2 ** -6
    (got * torch.from_numpy(c)).sum().backward()
    assert _rel(tx.grad, want_grads[1]) <= 3e-2
    assert _rel(tz.grad, want_grads[2]) <= 3e-2
    grads = from_jax_variables(jax.tree.map(np.asarray, want_grads[0]["params"]))
    assert set(grads) == {n for n, _ in tmod.named_parameters()}
    for name, p in tmod.named_parameters():
        assert _rel(p.grad, grads[name].numpy()) <= 3e-2, name


def test_layer_norm_is_flaxs_in_bf16():
    """The LayerNorm of a bf16 model: Flax's statistics in float32 and its
    epsilon 1e-6, one cast to bf16 (to bf16 rounding: one ulp)."""
    from flax import linen as nn

    from neural_jacobian_field_torch.models.transformer import LayerNorm

    rng = np.random.default_rng(1)
    x = (3.0 + rng.normal(size=(4, 7, DIM))).astype(np.float32)
    scale = (1.0 + 0.1 * rng.normal(size=DIM)).astype(np.float32)
    bias = (0.1 * rng.normal(size=DIM)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = nn.LayerNorm(dtype=jnp.bfloat16).apply({"params": {"scale": scale, "bias": bias}},
                                                  xb)
    ln = LayerNorm(DIM, torch.bfloat16)
    ln.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = ln(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and ln.eps == 1e-6
    assert _rel(got.float(), np.asarray(want, np.float32)) <= 2 ** -7


@pytest.mark.parametrize("norm_type", ["group", "instance", "none"])
@pytest.mark.parametrize("layout", ["pyramid", "concat"])
def test_encoder_norms_match_jax(norm_type, layout):
    """The encoder under each norm, in eval and in training mode (the same
    for these norms: no running statistics), and the image gradient of a
    random projection of the features."""
    from neural_jacobian_field_tpu.models.encoder_resnet import (
        EncoderResnet as JEnc, EncoderResnetCfg as JCfg)
    from neural_jacobian_field_torch.models.encoder_resnet import (
        EncoderResnet, EncoderResnetCfg)

    h, w = IMAGE_HW
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(2, h, w, 3)).astype(np.float32)
    jenc = JEnc(cfg=JCfg(norm_type=norm_type, conv_impl="xla", feature_layout=layout))
    variables = randomize_variables(jax.tree.map(np.asarray, dict(
        jenc.init(jax.random.PRNGKey(0), jnp.asarray(img)))))
    assert set(variables) == {"params"}

    def levels(out):
        return [out.fine, out.mid, out.coarse] if layout == "pyramid" else [out]

    want = levels(jenc.apply(variables, jnp.asarray(img)))
    cots = [rng.normal(size=v.shape).astype(np.float32) for v in want]
    want_dimg = jax.grad(lambda x: sum(jnp.sum(v * c) for v, c in zip(
        levels(jenc.apply(variables, x)), cots)))(jnp.asarray(img))

    tenc = EncoderResnet(EncoderResnetCfg(norm_type=norm_type, conv_impl="xla",
                                          feature_layout=layout))
    tenc.load_state_dict(from_jax_variables(variables["params"]), strict=True)
    assert not list(tenc.buffers())
    timg = torch.from_numpy(img).requires_grad_()
    got = levels(tenc(timg, train=True))
    for g, wv in zip(got, want):
        assert _rel(g.detach(), wv) <= 1e-4
    sum((g * torch.from_numpy(c)).sum() for g, c in zip(got, cots)).backward()
    assert _rel(timg.grad, want_dimg) <= 1e-4
    with torch.no_grad():
        assert all(torch.equal(a, b) for a, b in zip(levels(tenc(timg)), got))


def test_group_norm_bf16_is_flaxs():
    """GroupNorm of a bf16 encoder: statistics and normalisation in float32,
    one cast to bf16 (one bf16 ulp of Flax's)."""
    from flax import linen as nn

    from neural_jacobian_field_torch.models.encoder_resnet import GroupNorm

    rng = np.random.default_rng(2)
    c = 64
    x = (1.0 + rng.normal(size=(2, 6, 8, c))).astype(np.float32)
    scale = (1.0 + 0.1 * rng.normal(size=c)).astype(np.float32)
    bias = (0.1 * rng.normal(size=c)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = nn.GroupNorm(num_groups=32, epsilon=1e-5, dtype=jnp.bfloat16).apply(
        {"params": {"scale": scale, "bias": bias}}, xb)
    gn = GroupNorm(c, 32)
    gn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = gn(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), np.asarray(want, np.float32)) <= 2 ** -7
