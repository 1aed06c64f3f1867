"""The fused Jacobian-transformer layer (ops/kernels/attn_layer.py, JT-fwd /
JT-bwd's plain versions) against autograd of the per-op module
(models/transformer.py), and the module's dispatch, on the CPU. No JAX.

One layer at the kernels' widths (dim 64, 8 heads of 64, hidden 64) over
300 points, K and V from an index embedding of 6 (the toy arm's actions)
or 8 keys (allegro's) through to_kv. In float32 compute the plain version
rounds nothing, so it and autograd compute the same function by other
sums: its output and every gradient, the index embedding's through to_kv
included, agree to 1e-5 of scale (float32 sums in another order; the
weight gradients of W_q, K, W_out and V are formed from the reductions M =
a1^T dscore and R = p^T dx1, not from dq and o). In bf16 compute both round
at the module's points, but autograd also rounds dP, dx1, da1, da2 and the
bias gradients to bf16 where the plain version keeps float32, and the
plain version's dK and dW_out read q and o before their bf16 rounding:
each such rounding moves a value by up to 2^-8 of itself, so the gradients
agree to 3e-2 of scale (measured: at most 1.1e-2 over these cases). The
forward rounds at the same points in both, so each branch's output (x1 - x,
y - x1; y - x of a 3-layer stack) is held to one bf16 rounding, 2^-8 of its
scale (measured: at most 3.9e-4 a layer, 2.0e-3 over 3 layers); a dropped
rounding of the scores, or an unrounded branch, moves a branch by more
(5.8e-3 to 7.5e-3 on these inputs).
"""

import pytest
import torch

from neural_jacobian_field_torch.models.transformer import Transformer
from neural_jacobian_field_torch.ops.kernels import attn_layer as K
from neural_jacobian_field_torch.utils import profiling

N, WIDTH, HEADS, DIM_HEAD, HIDDEN = 300, 64, 8, 64, 64
TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
FWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -8}


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _module(dtype, depth=1, hidden=HIDDEN, seed=0):
    """The per-op module with seeded weights moved off their initial values
    (LayerNorm scales and biases, and biases, random too)."""
    m = Transformer(WIDTH, depth, HEADS, DIM_HEAD, hidden, selfatt=False, kv_dim=WIDTH,
                    compute_dtype=dtype)
    g = torch.Generator().manual_seed(seed)
    m.init_weights(g)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    return m


def _inputs(keys, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(N, WIDTH, generator=g)
    z = torch.randn(1, keys, WIDTH, generator=g)
    c = torch.randn(N, WIDTH, generator=g)
    return x, z, c


def _layer_weights(m, i=0):
    attn, ff = getattr(m, f"layers_{i}_attn"), getattr(m, f"layers_{i}_ff")
    an, fn = getattr(m, f"layers_{i}_attn_norm"), getattr(m, f"layers_{i}_ff_norm")
    return K.LayerWeights(an.weight, an.bias, attn.to_q.weight, attn.to_out.weight,
                          attn.to_out.bias, fn.weight, fn.bias, ff.fc1.weight, ff.fc1.bias,
                          ff.fc2.weight, ff.fc2.bias)


def _per_op(m, x, z, c):
    """Autograd of the per-op module: y, dx, dz and every parameter's grad."""
    m.zero_grad()
    x = x.clone().requires_grad_()
    z = z.clone().requires_grad_()
    m._fused = lambda *_: False
    y = m(x, z)
    (y * c).sum().backward()
    del m._fused
    return y.detach(), x.grad, z.grad, {n: p.grad.clone() for n, p in m.named_parameters()}


@pytest.mark.parametrize("keys", [6, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_layer_matches_autograd_of_the_per_op_module(dtype, keys):
    """The plain forward and backward at `dtype`'s roundings against the
    per-op module's autograd: each branch's output (x1 - x, y - x1), dx,
    every parameter's gradient and the index embedding's through to_kv (dK,
    dV chained by autograd)."""
    m = _module(dtype)
    x, z, c = _inputs(keys)
    y_want, dx_want, dz_want, grads = _per_op(m, x, z, c)
    with torch.no_grad():
        x1_want = x + m.layers_0_attn(m.layers_0_attn_norm(x), z)
        assert torch.equal(x1_want + m.layers_0_ff(m.layers_0_ff_norm(x1_want)), y_want)

    zz = z.clone().requires_grad_()
    attn = m.layers_0_attn
    k, v = torch.nn.functional.linear(
        zz[0].to(dtype), attn.to_kv.weight.to(dtype)).chunk(2, dim=-1)
    p = _layer_weights(m)
    scale = DIM_HEAD ** -0.5
    with torch.no_grad():
        y = K.attn_layer_fwd_plain(x, k, v, p, scale, dtype=dtype)
        x1 = K._forward_plain(x, k, v, p, scale, dtype)["x1"]
        dx, dk, dv, dp = K.attn_layer_bwd_plain(x, c, k, v, p, scale, dtype=dtype)
    assert _rel(x1 - x, x1_want - x) <= FWD_TOL[dtype]
    assert _rel(y - x1, y_want - x1_want) <= FWD_TOL[dtype]
    tol = TOL[dtype]
    assert _rel(dx, dx_want) <= tol
    names = ["layers_0_attn_norm.weight", "layers_0_attn_norm.bias", "layers_0_attn.to_q.weight",
             "layers_0_attn.to_out.weight", "layers_0_attn.to_out.bias",
             "layers_0_ff_norm.weight", "layers_0_ff_norm.bias", "layers_0_ff.fc1.weight",
             "layers_0_ff.fc1.bias", "layers_0_ff.fc2.weight", "layers_0_ff.fc2.bias"]
    for name, got in zip(names, dp):
        assert got.shape == grads[name].shape, name
        assert _rel(got, grads[name]) <= tol, (name, _rel(got, grads[name]))
    torch.autograd.backward([k, v], [dk.to(k.dtype), dv.to(v.dtype)])
    assert _rel(zz.grad, dz_want) <= tol
    w_kv = torch.autograd.grad(
        torch.nn.functional.linear(z[0].to(dtype), attn.to_kv.weight.to(dtype)),
        attn.to_kv.weight, torch.cat([dk, dv], dim=-1).to(dtype))[0]
    assert _rel(w_kv, grads["layers_0_attn.to_kv.weight"]) <= tol


@pytest.mark.parametrize("keys", [6, 8])
def test_fused_module_matches_per_op_module(keys):
    """A bf16 stack of 3 layers (the decoder's depth) dispatched to the
    fused layer on the CPU against the same module on its per-op path: the
    stack's change to its input (y - x), the input and key gradients and
    every parameter's gradient."""
    m = _module(torch.bfloat16, depth=3)
    x, z, c = _inputs(keys, seed=2)
    y_want, dx_want, dz_want, grads = _per_op(m, x, z, c)
    m.zero_grad()
    xx, zz = x.clone().requires_grad_(), z.clone().requires_grad_()
    assert m._fused(xx, zz)
    y = m(xx, zz)
    (y * c).sum().backward()
    assert _rel(y.detach() - x, y_want - x) <= FWD_TOL[torch.bfloat16]
    assert _rel(xx.grad, dx_want) <= TOL[torch.bfloat16]
    assert _rel(zz.grad, dz_want) <= TOL[torch.bfloat16]
    for name, p in m.named_parameters():
        assert _rel(p.grad, grads[name]) <= TOL[torch.bfloat16], name


def test_plain_layer_with_a_narrow_hidden_layer():
    """hidden 48 (fc1 and fc2 padded to 64 in the kernels' packing): the
    plain layer in float32 against the per-op module to 1e-5 of scale, and
    the packing's padding is zeros."""
    m = _module(torch.float32, hidden=48)
    x, z, c = _inputs(8)
    y_want, dx_want, _, grads = _per_op(m, x, z, c)
    k, v = torch.nn.functional.linear(z[0], m.layers_0_attn.to_kv.weight).chunk(2, dim=-1)
    p = _layer_weights(m)
    with torch.no_grad():
        y = K.attn_layer_fwd_plain(x, k, v, p, 0.125, dtype=torch.float32)
        dx, _, _, dp = K.attn_layer_bwd_plain(x, c, k, v, p, 0.125, dtype=torch.float32)
        w = K.pack_weights(k, v, p)
    assert _rel(y - x, y_want - x) <= FWD_TOL[torch.float32]
    assert _rel(dx, dx_want) <= TOL[torch.float32]
    assert _rel(dp.w1, grads["layers_0_ff.fc1.weight"]) <= TOL[torch.float32]
    assert _rel(dp.w2, grads["layers_0_ff.fc2.weight"]) <= TOL[torch.float32]
    assert w.shape == (K.ROWS, 64) and w.dtype == torch.bfloat16
    assert not w[1024 + 48:1088].any() and not w[1088:1152, 48:].any()
    assert not w[1152:1280].reshape(8, 16, 64)[:, 8:].any()


def test_pack_weights_layout():
    """The packed rows the kernels read: W_q as it is, W_out's column block
    of head h at 512 + 64 h, fc1, fc2, then K and V head by head, 16 rows a
    head; the biases b_out, b1, b2 rounded to bf16, then the LayerNorms'."""
    m = _module(torch.bfloat16)
    _, z, _ = _inputs(6)
    k, v = torch.nn.functional.linear(z[0], m.layers_0_attn.to_kv.weight).chunk(2, dim=-1)
    p = _layer_weights(m)
    w, b = K.pack_weights(k, v, p), K.pack_biases(p)
    bf = torch.bfloat16
    assert torch.equal(w[:512], p.wq.to(bf))
    for h in range(HEADS):
        assert torch.equal(w[512 + 64 * h:576 + 64 * h], p.wout[:, 64 * h:64 * h + 64].to(bf))
        assert torch.equal(w[1152 + 16 * h:1158 + 16 * h], k[:, 64 * h:64 * h + 64].to(bf))
        assert torch.equal(w[1280 + 16 * h:1286 + 16 * h], v[:, 64 * h:64 * h + 64].to(bf))
    assert torch.equal(w[1024:1088], p.w1.to(bf)) and torch.equal(w[1088:1152], p.w2.to(bf))
    assert b.shape == (K.BIAS_FLOATS,) and b.dtype == torch.float32
    assert torch.equal(b[:64], p.bout.to(bf).float())
    assert torch.equal(b[192:256], p.ln1_w) and torch.equal(b[384:], p.ln2_b)


def _counted(m, x, z, monkeypatch):
    """The module's output and the `attn_fused_points` of a program run
    around it."""
    monkeypatch.setattr(profiling, "_REG", profiling._Registry())
    pid = profiling.new_program("t")
    with profiling.program(pid, torch.device("cpu")):
        y = m(x, z)
    (counts,) = profiling.counters().values()
    return y, counts["attn_fused_points"]


@pytest.mark.parametrize("case", ["bf16", "f32", "dim 16", "hidden 96", "9 keys", "17 keys",
                                  "bf16 x"])
def test_dispatch_by_observable_input(case, monkeypatch):
    """The fused layer serves a bf16 module at the kernels' widths with a
    float32 residual (attn_fused_points = points x layers); float32 compute,
    other widths, more than 8 keys or a bf16 residual keep the per-op path
    (attn_fused_points 0), bit for bit what the per-op code gives."""
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    dim = 16 if case == "dim 16" else WIDTH
    heads, dim_head = (2, 8) if case == "dim 16" else (HEADS, DIM_HEAD)
    hidden = 96 if case == "hidden 96" else HIDDEN
    keys = {"9 keys": 9, "17 keys": 17}.get(case, 8)
    m = Transformer(dim, 2, heads, dim_head, hidden, selfatt=False, kv_dim=dim,
                    compute_dtype=dtype)
    m.init_weights(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 50, dim, generator=g)
    if case == "bf16 x":
        x = x.to(torch.bfloat16)
    z = torch.randn(1, keys, dim, generator=g)
    with torch.no_grad():
        y, points = _counted(m, x, z, monkeypatch)
        m._fused = lambda *_: False
        y_per_op = m(x, z)
    if case == "bf16":
        assert points == 2 * 100
        assert _rel(y - x, y_per_op - x) <= FWD_TOL[torch.bfloat16]
    else:
        assert points == 0
        assert torch.equal(y, y_per_op)


def test_cuda_wrappers_raise_off_their_instantiation():
    """The CUDA wrappers check shapes before anything reaches the card:
    more than 8 keys or a wrong width raise (on the CPU the argument check
    runs ahead of the device check)."""
    m = _module(torch.bfloat16)
    p = _layer_weights(m)
    k = torch.zeros(9, 512)
    with pytest.raises(ValueError):
        K._check(torch.zeros(4, 64), k, k, p, "attn_layer_fwd")
    with pytest.raises(ValueError):
        K._check(torch.zeros(4, 32), k[:8], k[:8], p, "attn_layer_fwd")
    K._check(torch.zeros(4, 64), k[:8], k[:8], p, "attn_layer_fwd")
