"""A stage-1 train step repeats bit for bit: the JAX package's on the CPU,
and the port's; the port's fixed-order backwards (ops/deterministic.py)
against autograd's; the generalised K1-bwd scatter's plain version.

The JAX step is the reference semantics: run twice from one state, every
metric and every state leaf comes out bit-identical. The port's step is held
to the same on the CPU (on the card, chip_smoke.py's phases 5, 8 and 10 hold
its eager runs and its captured replays to it). The backwards that replace
PyTorch's atomic ones are held against autograd through the ops they
replace, in float64, within 1e-12 of the gradient's scale. The stem's
max-pool keeps PyTorch's backward (on CUDA a gather, no atomics): its
values and gradients against Flax's, ties included (the first maximum of a
window in row-major order gets the gradient).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port_common import (
    INTRINSICS, IMAGE_HW, jax_model_cfg, look_at_offset, torch_model_cfg)
from neural_jacobian_field_torch.models.encoder_resnet import max_pool_3x3s2
from neural_jacobian_field_torch.ops.deterministic import (
    deterministic_cudnn, gather_rows, upsample_bilinear)
from neural_jacobian_field_torch.ops.grid_sample import grid_sample_bilinear
from neural_jacobian_field_torch.ops.kernels import onehot_gather as k1
from neural_jacobian_field_torch.ops.losses import outer_measure

RAYS = 16
TOL = 1e-12


def _batch_arrays(seed=11, b=2):
    rng = np.random.default_rng(seed)
    h, w = IMAGE_HW
    return dict(
        ctxt_rgb=rng.integers(0, 256, size=(b, h, w, 3), dtype=np.uint8),
        ctxt_extrinsics=np.broadcast_to(np.eye(4, dtype=np.float32), (b, 4, 4)).copy(),
        ctxt_intrinsics=np.broadcast_to(INTRINSICS, (b, 3, 3)).copy(),
        robot_action=rng.normal(size=(b, 4)).astype(np.float32),
        trgt_rgb=rng.integers(0, 256, size=(b, h, w, 3), dtype=np.uint8),
        trgt_depth=rng.uniform(1.0, 3.5, size=(b, h, w, 1)).astype(np.float32),
        trgt_extrinsics=np.stack([look_at_offset(10.0), look_at_offset(-8.0)]),
        trgt_intrinsics=np.broadcast_to(INTRINSICS, (b, 3, 3)).copy(),
        near=np.full((b,), 0.5, np.float32), far=np.full((b,), 4.0, np.float32))


def _leaves_equal(a, b) -> list:
    """Names of the leaves of two pytrees (numpy) that differ in any bit."""
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = jax.tree_util.tree_flatten_with_path(b)[0]
    assert len(fa) == len(fb)
    return [jax.tree_util.keystr(p) for (p, x), (_, y) in zip(fa, fb)
            if not np.array_equal(np.asarray(x), np.asarray(y))]


def test_jax_stage1_step_repeats_bit_for_bit():
    """The reference: JAX's make_train_step twice from one state and key on
    the CPU, both gates in one program: every metric and every state leaf
    (params, batch_stats, optax state, counters) bit-identical."""
    from neural_jacobian_field_tpu.models import model as jm
    from neural_jacobian_field_tpu.training import prepare as jp
    from neural_jacobian_field_tpu.training import train as jt

    jbatch = jp.RawBatch(**{k: jnp.asarray(v) for k, v in _batch_arrays().items()})
    jmodel = jm.Model(cfg=jax_model_cfg())
    jcfg = jt.TrainCfg(lr=5e-4, warm_up_steps=4, rays_per_batch=RAYS)
    st = jt.create_train_state(jax.random.PRNGKey(0), jmodel, jbatch, jcfg)
    step = jt.make_train_step(jmodel, jcfg, donate=False)
    runs = []
    for _ in range(2):
        s, out = st, []
        for i in range(2):
            s, metrics = step(s, jbatch, jax.random.PRNGKey(30 + i))
            out.append(metrics)
        runs.append(jax.tree.map(np.asarray, (out, s)))
    assert _leaves_equal(runs[0], runs[1]) == []


@pytest.mark.parametrize("mode", ["epipolar", "exact"])
def test_port_stage1_step_repeats_bit_for_bit(mode):
    """The port's eager train_step twice from one state with the same draws
    (two steps, update then frozen): every metric, parameter, BatchNorm
    statistic and Adam tensor bit-identical."""
    from dataclasses import replace

    from neural_jacobian_field_torch.models.model import Model
    from neural_jacobian_field_torch.training import (
        RawBatch, TrainCfg, create_train_state, step_randomness, train_step)

    torch.set_num_threads(1)
    cfg = torch_model_cfg()
    cfg = replace(cfg, rendering=replace(cfg.rendering, pixel_feature_mode=mode))
    model = Model(cfg).init_weights(torch.Generator().manual_seed(0))
    batch = RawBatch(**{k: torch.from_numpy(v) for k, v in _batch_arrays().items()})
    state = create_train_state(model, TrainCfg(lr=5e-4, warm_up_steps=4, rays_per_batch=RAYS))
    g = torch.Generator().manual_seed(3)
    plan = [(u, *step_randomness(state, batch, g)) for u in (True, False)]
    start = copy.deepcopy((model.state_dict(), state.optimizer.state_dict()))
    runs = []
    for _ in range(2):
        model.load_state_dict(start[0])
        state.optimizer.load_state_dict(start[1])
        out = [train_step(state, batch, None, u, yx=yx, draws=d) for u, yx, d in plan]
        opt = state.optimizer
        runs.append(([v.clone() for m in out for v in m.values()]
                     + [t.detach().clone() for t in model.state_dict().values()]
                     + [t.clone() for t in opt.state_tensors()]))
    assert len(runs[0]) > 50
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# ------------------------------------------------- the fixed-order backwards


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


def test_gather_rows_backward_is_gathers():
    """gather_rows's gradient is torch.gather's (a scatter-add), in
    float64, within 1e-12 of scale; its forward the same rows; a hot row."""
    rng = np.random.default_rng(0)
    flat = torch.from_numpy(rng.normal(size=(3, 11, 7))).requires_grad_(True)
    idx = torch.from_numpy(rng.integers(0, 11, size=(3, 200)))
    idx[:, :90] = 4
    g = torch.from_numpy(rng.normal(size=(3, 200, 7)))
    got = gather_rows(flat, idx)
    want = torch.gather(flat, 1, idx[..., None].expand(-1, -1, 7))
    assert torch.equal(got, want)
    (a,), (b,) = (torch.autograd.grad(y, flat, g) for y in (got, want))
    assert _rel(a, b) <= TOL


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_grid_sample_backward_against_four_gathers(padding_mode):
    """grid_sample_bilinear (one gather_rows of the four corners) against
    the same formula with four torch.gather calls: values bit for bit, the
    feature map's gradient within 1e-12 of scale (float64), coordinates
    past the border included."""
    rng = np.random.default_rng(1)
    feats = torch.from_numpy(rng.normal(size=(2, 6, 9, 5))).requires_grad_(True)
    coords = torch.from_numpy(rng.uniform(-1.2, 1.2, size=(2, 150, 2)))

    def four_gathers(f):
        b, h, w, c = f.shape
        x = (coords[..., 0] + 1.0) * 0.5 * (w - 1)
        y = (coords[..., 1] + 1.0) * 0.5 * (h - 1)
        if padding_mode == "border":
            x = torch.minimum(torch.maximum(x, torch.zeros_like(x)), torch.full_like(x, w - 1.0))
            y = torch.minimum(torch.maximum(y, torch.zeros_like(y)), torch.full_like(y, h - 1.0))
        x0, y0 = torch.floor(x), torch.floor(y)
        x1, y1 = x0 + 1, y0 + 1
        wx, wy = (x - x0)[..., None], (y - y0)[..., None]
        flat = f.reshape(b, h * w, c)

        def take(yi, xi):
            idx = (torch.clamp(yi, 0, h - 1).long() * w + torch.clamp(xi, 0, w - 1).long())
            out = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
            if padding_mode == "zeros":
                valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
                out = out * valid[..., None].to(out.dtype)
            return out

        top = take(y0, x0) * (1.0 - wx) + take(y0, x1) * wx
        bot = take(y1, x0) * (1.0 - wx) + take(y1, x1) * wx
        return top * (1.0 - wy) + bot * wy

    got, want = grid_sample_bilinear(feats, coords, padding_mode), four_gathers(feats)
    assert torch.equal(got, want)
    g = torch.from_numpy(rng.normal(size=got.shape))
    (a,), (b,) = (torch.autograd.grad(y, feats, g) for y in (got, want))
    assert _rel(a, b) <= TOL


@pytest.mark.parametrize("hi,wi,ho,wo", [(3, 4, 6, 8), (3, 5, 24, 40), (4, 4, 7, 9),
                                         (2, 3, 16, 24)])
def test_upsample_backward_is_interpolates(hi, wi, ho, wo):
    """upsample_bilinear: F.interpolate's values bit for bit (half-pixel
    centres), its gradient against F.interpolate's autograd within 1e-12 of
    scale (float64): 2x, 8x and a ratio that is not a power of two."""
    rng = np.random.default_rng(hi * wo)
    x = torch.from_numpy(rng.normal(size=(2, hi, wi, 3))).requires_grad_(True)
    got = upsample_bilinear(x, (ho, wo))
    want = F.interpolate(x.permute(0, 3, 1, 2), size=(ho, wo), mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)
    assert torch.equal(got, want)
    g = torch.from_numpy(rng.normal(size=got.shape))
    (a,), (b,) = (torch.autograd.grad(y, x, g) for y in (got, want))
    assert _rel(a, b) <= TOL


@pytest.mark.parametrize("h,w,tied", [(8, 10, False), (7, 9, False), (12, 16, True)])
def test_max_pool_backward_is_max_pools(h, w, tied):
    """The stem's max_pool_3x3s2 against flax's nn.max_pool (3x3, stride 2,
    pad 1): values bit for bit, the gradient of integer cotangents bit for
    bit (its sums exact), odd sizes and tied inputs included; without a
    gradient the same values."""
    from flax import linen as nn

    rng = np.random.default_rng(h + w)
    v = rng.normal(size=(2, h, w, 4)).astype(np.float32)
    if tied:
        v = np.round(v)  # a few levels: most windows hold ties
    gy = rng.integers(-4, 5, size=(2, (h + 1) // 2, (w + 1) // 2, 4)).astype(np.float32)
    y_jax, vjp = jax.vjp(
        lambda t: nn.max_pool(t, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1))),
        jnp.asarray(v))
    x = torch.from_numpy(v).requires_grad_(True)
    got = max_pool_3x3s2(x)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(y_jax))
    (a,) = torch.autograd.grad(got, x, torch.from_numpy(gy))
    np.testing.assert_array_equal(a.numpy(), np.asarray(vjp(jnp.asarray(gy))[0]))
    with torch.no_grad():
        assert torch.equal(max_pool_3x3s2(x), got)


def test_max_pool_ties_take_jaxs_choice():
    """On tied inputs (values in {0, 1, 2}), the port's gradient is JAX's
    (flax nn.max_pool's VJP): each window's gradient goes to its first
    maximum in row-major order. Integer gradients, so the sums are exact."""
    from flax import linen as nn

    rng = np.random.default_rng(5)
    v = rng.integers(0, 3, size=(2, 10, 14, 3)).astype(np.float32)
    gy = rng.integers(-4, 5, size=(2, 5, 7, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: nn.max_pool(t, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1))),
                     jnp.asarray(v))
    want = np.asarray(vjp(jnp.asarray(gy))[0])
    x = torch.from_numpy(v).requires_grad_(True)
    (got,) = torch.autograd.grad(max_pool_3x3s2(x), x, torch.from_numpy(gy))
    np.testing.assert_array_equal(got.numpy(), want)


def test_outer_measure_backward_is_gathers():
    """The interlevel loss's outer measure (one gather_rows per ray) against
    the two torch.gather calls it replaces: values bit for bit, the
    proposal weights' gradient within 1e-12 of scale (float64)."""
    rng = np.random.default_rng(2)
    t0 = torch.from_numpy(np.sort(rng.uniform(size=(3, 4, 9)), axis=-1))
    t1 = torch.from_numpy(np.sort(rng.uniform(size=(3, 4, 6)), axis=-1))
    y1 = torch.from_numpy(rng.uniform(size=(3, 4, 5))).requires_grad_(True)

    def gathers(y):
        cy1 = torch.cat([torch.zeros_like(y[..., :1]), torch.cumsum(y, dim=-1)], dim=-1)
        lo = torch.clamp(torch.searchsorted(t1[..., :-1].contiguous(), t0[..., :-1].contiguous(),
                                            right=True) - 1, 0, 4)
        hi = torch.clamp(torch.searchsorted(t1[..., 1:].contiguous(), t0[..., 1:].contiguous(),
                                            right=True), 0, 4)
        return torch.gather(cy1[..., 1:], -1, hi) - torch.gather(cy1[..., :-1], -1, lo)

    got, want = outer_measure(t0, t1, y1), gathers(y1)
    assert torch.equal(got, want)
    g = torch.from_numpy(rng.normal(size=got.shape))
    (a,), (b,) = (torch.autograd.grad(y, y1, g) for y in (got, want))
    assert _rel(a, b) <= TOL


@pytest.mark.parametrize("q,weighted", [(1, False), (4, True), (1, True)])
def test_row_scatter_plain_against_scatter_add(q, weighted):
    """The generalised scatter's plain version against scatter_add_ in
    float64 (within 1e-12 of scale), and bit-identical across two runs in
    float32, where the order of its sums shows; bf16 g takes its weights
    rounded to bf16, as the kernel does, and its float32 sums come back
    rounded to bf16."""
    rng = np.random.default_rng(7 + q)
    b, n, k, c = 2, 500, 13, 6
    idx = torch.from_numpy(rng.integers(0, k, size=(b, n, q)))
    w = torch.from_numpy(rng.uniform(size=(b, n, q))) if weighted else None
    g = torch.from_numpy(rng.normal(size=(b, n, c)) * 10.0 ** rng.integers(-3, 4, size=(b, n, 1)))
    got = k1.row_scatter_plain(g, idx, w, k)
    want = torch.zeros((b, k, c), dtype=torch.float64)
    for j in range(q):
        src = g if w is None else w[..., j:j + 1] * g
        want.scatter_add_(1, idx[..., j:j + 1].expand(-1, -1, c), src)
    assert got.dtype == torch.float64 and _rel(got, want) <= TOL
    runs = [k1.row_scatter_plain(g.float(), idx, None if w is None else w.float(), k)
            for _ in range(2)]
    assert runs[0].dtype == torch.float32 and torch.equal(runs[0], runs[1])
    if weighted:
        gb = g.to(torch.bfloat16)
        rounded = k1.row_scatter_plain(gb.float(), idx, w.float().to(torch.bfloat16), k)
        got_b = k1.row_scatter_plain(gb, idx, w.float(), k)
        assert got_b.dtype == torch.bfloat16 and torch.equal(got_b, rounded.to(torch.bfloat16))


@pytest.mark.parametrize("q,weighted", [(4, True), (1, False)])
def test_row_scatter_plain_shared_table(q, weighted):
    """One table of ids (and weights) for every image, [1, N, Q], sums as
    the same table repeated per image, bit for bit."""
    rng = np.random.default_rng(3 + q)
    b, n, k, c = 3, 400, 11, 5
    idx = torch.from_numpy(rng.integers(0, k, size=(1, n, q)))
    w = torch.from_numpy(rng.uniform(size=(1, n, q)).astype(np.float32)) if weighted else None
    g = torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32))
    got = k1.row_scatter_plain(g, idx, w, k)
    want = k1.row_scatter_plain(g, idx.expand(b, -1, -1),
                                None if w is None else w.expand(b, -1, -1), k)
    assert got.shape == (b, k, c) and torch.equal(got, want)


def test_row_scatter_plain_sums_in_entry_order():
    """Each row's terms in entry order, one after another: (1e8 + 1) - 1e8
    + 1 is 1 in float32 that way (any other order gives 0 or 2)."""
    g = torch.tensor([[[1e8], [1.0], [-1e8], [1.0]]])
    idx = torch.zeros((1, 4, 1), dtype=torch.long)
    assert k1.row_scatter_plain(g, idx, None, 1).item() == 1.0


def test_deterministic_cudnn_is_scoped():
    """The flag is set inside the block and restored after it, whatever it
    was; nothing else of cuDNN's settings changes."""
    cudnn = torch.backends.cudnn
    before = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32, cudnn.enabled)
    for outer in (False, True):
        cudnn.deterministic = outer
        with deterministic_cudnn():
            assert cudnn.deterministic
            assert (cudnn.benchmark, cudnn.allow_tf32, cudnn.enabled) == before[1:]
        assert cudnn.deterministic == outer
    cudnn.deterministic = before[0]
