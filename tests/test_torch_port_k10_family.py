"""Where `pallas_fused` takes BatchNorm statistics from the conv, against the
JAX package on the CPU.

JAX's `_ConvK9` emits K10's statistics only where `conv3x3_supported` holds
(a row block with a divisor of the output height in 4..16, W >= 2, the
assembled operand within 6 MiB); elsewhere it runs the conv through XLA
and `BatchNormFromStats` sums y itself. The port's kernel takes every
shape, so its encoder asks `conv_suite.conv3x3_s1_supported`, a copy of
that predicate, before it takes the statistics. Here the copy is held
against JAX's predicate; one bf16 BasicBlock in training mode against
JAX's from the same bf16 input, on and off the family; and the whole
pallas_fused encoder in bf16 against JAX's at a 48x64 image, where
layer3's stride-1 convs (height 3) are off the family.

What the fault costs is small next to bf16's own noise: a BatchNorm that
takes the float32 accumulator's sums instead of the bf16 y's moves the
running statistics by 1e-5 to 4e-4 of scale and the block's output by a
bf16 step at 7-16% of its elements (measured here), while two encoders
that agree on every decision still differ by 7.6e-3 / 1.7e-2 / 5.7e-2 of
scale at the fine / mid / coarse levels in bf16 (measured at 64x32, on
the family everywhere: one bf16 rounding flipped early, carried through 16
BatchNorms). So the block is where the repair shows; the encoder test
holds the decisions (K10's launches) and the noise floor.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_jacobian_field_torch.ops.kernels import conv_suite
from neural_jacobian_field_torch.utils.from_jax import from_jax_variables


def _stride1_shapes(h, w):
    """The encoder's stride-1 conv inputs (B = 1) at an h x w image: the 7x7/2
    stem, the 3x3/2 max-pool, then layer1 (64), layer2 (128), layer3 (256),
    each of the later two after a stride-2 conv."""
    def down(n, k, p):
        return (n + 2 * p - k) // 2 + 1

    h, w = down(down(h, 7, 3), 3, 1), down(down(w, 7, 3), 3, 1)
    shapes = [(1, h, w, 64)]
    for c in (128, 256):
        h, w = down(h, 3, 1), down(w, 3, 1)
        shapes.append((1, h, w, c))
    return shapes


ENCODER = sorted({s for hw in ((480, 640), (64, 32), (48, 64), (76, 96))
                  for s in _stride1_shapes(*hw)})
OTHER = [(2, h, w, c) for h in (3, 5, 7, 11, 13, 19, 24, 26, 40) for w, c in ((1, 64), (40, 64))] \
    + [(1, 30, 640, 256), (1, 40, 160, 512), (1, 12, 2, 8)]


@pytest.mark.parametrize("shape", ENCODER + OTHER, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_predicate_equals_jax_conv3x3_supported(shape, dtype):
    from neural_jacobian_field_tpu.ops.pallas import conv_suite as jk

    want = jk.conv3x3_supported(shape, shape[-1], 1, dtype=jnp.dtype(dtype))
    assert conv_suite.conv3x3_s1_supported(shape, jnp.dtype(dtype).itemsize) == want


def test_the_family_at_the_test_images():
    """48x64 puts layer3 (height 3) off the family, 76x96 layer1 (19); at
    480x640 every stride-1 conv is on it."""
    on = [conv_suite.conv3x3_s1_supported(s, 2) for s in _stride1_shapes(48, 64)]
    assert on == [True, True, False]
    assert [conv_suite.conv3x3_s1_supported(s, 2) for s in _stride1_shapes(76, 96)] \
        == [False, True, True]
    assert all(conv_suite.conv3x3_s1_supported(s, 2) for s in _stride1_shapes(480, 640))


ENC_HW = (48, 64)


@pytest.fixture(scope="module")
def fused_bf16():
    """JAX's pallas_fused encoder in training mode, bf16, on seeded weights
    and statistics, batch 2: the pyramid and the new running statistics."""
    from _torch_port_common import randomize_variables
    from neural_jacobian_field_tpu.models.encoder_resnet import EncoderResnet, EncoderResnetCfg

    rng = np.random.default_rng(5)
    image = rng.uniform(size=(2, *ENC_HW, 3)).astype(np.float32)
    jenc = EncoderResnet(EncoderResnetCfg(norm_type="batch", feature_layout="pyramid",
                                          conv_impl="pallas_fused"),
                         compute_dtype=jnp.bfloat16)
    variables = jax.tree.map(np.asarray, jenc.init(jax.random.PRNGKey(0), jnp.asarray(image)))
    variables = randomize_variables(variables, seed=6)
    pyr, new = jenc.apply(jax.tree.map(jnp.asarray, variables), jnp.asarray(image), train=True,
                          mutable=["batch_stats"])
    levels = [np.asarray(jnp.asarray(v, jnp.float32)) for v in (pyr.fine, pyr.mid, pyr.coarse)]
    return dict(image=image, variables=variables, levels=levels,
                new_stats=jax.tree.map(np.asarray, new["batch_stats"]))


def _rel(got, want):
    got = got.detach().float().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _counting_k10():
    calls = []
    plain = conv_suite.conv3x3_s1_stats

    def counted(x, w):
        calls.append(tuple(x.shape))
        return plain(x, w)

    return calls, mock.patch.object(conv_suite, "conv3x3_s1_stats", counted)


@pytest.mark.parametrize("shape,on_family", [
    ((2, 3, 4, 256), False),   # layer3 at 48x64
    ((2, 19, 24, 64), False),  # layer1 at 76x96
    ((2, 6, 8, 128), True),    # layer2 at 48x64
    ((2, 12, 16, 64), True),   # layer1 at 48x64
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_basic_block_bf16_takes_statistics_where_jax_does(shape, on_family):
    """A stride-1 BasicBlock under pallas_fused in training mode, bf16, from
    the same bf16 input and seeded weights: K10 runs at both convs on the
    family and at neither off it, and the output and running statistics
    agree with JAX's: at most 1e-2 of the output's elements a bf16 step
    apart (one float32 sum of the same products rounded the other way; with
    the statistics taken off the family, as before the repair, 6.6e-2 and
    0.155 measured), every running statistic within 2e-5 of its scale
    (float32 sums reordered: <= 7.4e-6 measured; before the repair 5.3e-5
    to 4.0e-4)."""
    from _torch_port_common import randomize_variables
    from neural_jacobian_field_tpu.models.encoder_resnet import BasicBlock as JaxBlock

    from neural_jacobian_field_torch.models.encoder_resnet import BasicBlock

    rng = np.random.default_rng(7)
    xb = jnp.asarray(rng.normal(size=shape).astype(np.float32), jnp.bfloat16)
    c = shape[-1]
    jb = JaxBlock(c, 1, "batch", compute_dtype=jnp.bfloat16, conv_impl="pallas_fused")
    v = randomize_variables(jax.tree.map(np.asarray, jb.init(jax.random.PRNGKey(0), xb)),
                            seed=8)
    want, new = jb.apply(jax.tree.map(jnp.asarray, v), xb, train=True, mutable=["batch_stats"])
    block = BasicBlock(c, c, 1, "batch", "pallas_fused")
    block.load_state_dict(from_jax_variables(v["params"], v["batch_stats"]), strict=True)
    calls, counting = _counting_k10()
    with counting:
        got = block(torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16),
                    train=True)
    assert len(calls) == (2 if on_family else 0)
    want = np.asarray(want.astype(jnp.float32), np.float64)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert float((got.detach().float().numpy() != want).mean()) <= 1e-2
    assert _rel(got, want) <= 2 ** -7
    bufs = dict(block.named_buffers())
    for name, w in from_jax_variables({}, jax.tree.map(np.asarray, new["batch_stats"])).items():
        assert _rel(bufs[name], w.numpy()) <= 2e-5, (name, _rel(bufs[name], w.numpy()))


def test_pallas_fused_bf16_encoder_off_family_matches_jax(fused_bf16):
    """The port's pallas_fused encoder in training mode, bf16, at 48x64: K10
    runs only at the 13 stride-1 convs of layer1 and layer2 (JAX's family);
    layer3's 11 take their BatchNorm statistics from y, as JAX's do. The
    pyramid and the running statistics against JAX's at bf16's noise floor
    (see the module's docstring): fine / mid / coarse within 2e-2 / 4e-2 /
    1e-1 of scale (7.6e-3 / 1.6e-2 / 4.7e-2 measured), the statistics within
    3e-2 of scale (6.6e-3 measured)."""
    from neural_jacobian_field_torch.models.encoder_resnet import (
        EncoderResnet, EncoderResnetCfg)

    ref = fused_bf16
    v = ref["variables"]
    enc = EncoderResnet(EncoderResnetCfg(norm_type="batch", feature_layout="pyramid",
                                         conv_impl="pallas_fused"), torch.bfloat16)
    enc.load_state_dict(from_jax_variables(v["params"], v["batch_stats"]), strict=True)
    calls, counting = _counting_k10()
    with counting:
        pyr = enc(torch.from_numpy(ref["image"]), train=True)
    assert len(calls) == 13 and all(s[3] in (64, 128) for s in calls)
    for got, want, tol in zip((pyr.fine, pyr.mid, pyr.coarse), ref["levels"], (2e-2, 4e-2, 1e-1)):
        assert _rel(got, want) <= tol
    want_stats = from_jax_variables({}, ref["new_stats"])
    bufs = dict(enc.named_buffers())
    for name, want in want_stats.items():
        assert _rel(bufs[name], want.numpy()) <= 3e-2, (name, _rel(bufs[name], want.numpy()))
