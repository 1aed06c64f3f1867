"""The port's hand-written Hopper kernels, one module per TPU kernel.

Each wrapper launches its CUDA kernel for a CUDA tensor and takes its plain
PyTorch version (same module, `*_plain`) for a CPU tensor, and counts its
launches in a plain integer attribute `launches` (the K9 and K7 wrappers
also those of their legacy kernel in `legacy_launches`). The differentiable entry
points (`conv_s1`, `conv_s1_stats`, `pack_2x2_flat_train`, `fused_resnet_fc_train`,
`fused_resnet_fc_train_tz`, `attn_layer`, `ops/pixel_gather.gather_bilinear_onehot`, and
`ops/deterministic.gather_rows` over K1-bwd-small or K1-bwd-rows, and
`upsample_bilinear` over K1-bwd-upsample) are autograd.Functions over these
wrappers.
"""

from .attn_layer import attn_layer_bwd, attn_layer_bwd_plain, attn_layer_fwd, attn_layer_fwd_plain
from .conv_suite import (
    conv3x3_s1, conv3x3_s1_dgrad, conv3x3_s1_dgrad_plain, conv3x3_s1_plain, conv3x3_s1_stats,
    conv3x3_s1_stats_plain, conv3x3_s1_wgrad, conv3x3_s1_wgrad_plain, conv_s1, conv_s1_stats)
from .field_mlp import (
    fused_resnet_fc, fused_resnet_fc_bwd, fused_resnet_fc_bwd_plain, fused_resnet_fc_plain,
    fused_resnet_fc_train, fused_resnet_fc_train_tz, fused_resnet_fc_tz,
    fused_resnet_fc_tz_bwd, fused_resnet_fc_tz_bwd_plain, fused_resnet_fc_tz_plain)
from .onehot_gather import (
    onehot_gather_fwd, onehot_gather_fwd_plain, onehot_scatter_bwd, onehot_scatter_bwd_plain,
    row_scatter, row_scatter_plain, small_plan, small_scatter, small_scatter_plain)
from .pack2x2 import (
    pack_2x2_flat, pack_2x2_flat_bwd, pack_2x2_flat_bwd_plain, pack_2x2_flat_plain,
    pack_2x2_flat_train)
from .pdf_resample import fused_sample_pdf, fused_sample_pdf_plain
from .upsample_bwd import upsample_bilinear_bwd, upsample_bilinear_bwd_plain

_TPU = "neural_jacobian_field_tpu/ops/pallas/"
_CSRC = "neural_jacobian_field_torch/csrc/"

# name -> (wrapper, plain version, CUDA source, the TPU kernel it replaces)
KERNELS = {
    "K9-fwd": (conv3x3_s1, conv3x3_s1_plain, _CSRC + "conv3x3_s1.cu",
               _TPU + "conv_suite.py:150"),
    "K10": (conv3x3_s1_stats, conv3x3_s1_stats_plain, _CSRC + "conv3x3_s1.cu",
            _TPU + "conv_suite.py:253"),
    "K9-dgrad": (conv3x3_s1_dgrad, conv3x3_s1_dgrad_plain, _CSRC + "conv3x3_s1.cu",
                 _TPU + "conv_suite.py:370"),
    "K9-wgrad": (conv3x3_s1_wgrad, conv3x3_s1_wgrad_plain, _CSRC + "conv3x3_wgrad.cu",
                 _TPU + "conv_suite.py:177"),
    "K6-fwd": (pack_2x2_flat, pack_2x2_flat_plain, _CSRC + "pack2x2.cu",
               _TPU + "pack2x2.py:71"),
    "K6-bwd": (pack_2x2_flat_bwd, pack_2x2_flat_bwd_plain, _CSRC + "pack2x2.cu",
               _TPU + "pack2x2.py:91"),
    "K5": (fused_sample_pdf, fused_sample_pdf_plain, _CSRC + "pdf_resample.cu",
           _TPU + "pdf_resample.py:79"),
    "K7-tz-fwd": (fused_resnet_fc_tz, fused_resnet_fc_tz_plain, _CSRC + "field_mlp.cu",
                  _TPU + "field_mlp_train.py:440"),
    "K7-tz-bwd": (fused_resnet_fc_tz_bwd, fused_resnet_fc_tz_bwd_plain,
                  _CSRC + "field_mlp_bwd.cu", _TPU + "field_mlp_train.py:471"),
    "K7-fwd": (fused_resnet_fc, fused_resnet_fc_plain, _CSRC + "field_mlp.cu",
               _TPU + "field_mlp_train.py:301"),
    "K7-bwd": (fused_resnet_fc_bwd, fused_resnet_fc_bwd_plain, _CSRC + "field_mlp_bwd.cu",
               _TPU + "field_mlp_train.py:337"),
    "K1-fwd": (onehot_gather_fwd, onehot_gather_fwd_plain, _CSRC + "onehot_gather.cu",
               _TPU + "onehot_gather.py:87"),
    "K1-bwd": (onehot_scatter_bwd, onehot_scatter_bwd_plain, _CSRC + "onehot_gather.cu",
               _TPU + "onehot_gather.py:119"),
    # K1-bwd's kernel generalised (Q entries per point, any width, unit
    # weights): the fixed-order backward of the pyramid's, the knots' and
    # the lookups' row gathers (ops/deterministic.py), where JAX runs XLA's
    # scatter-add
    "K1-bwd-rows": (row_scatter, row_scatter_plain, _CSRC + "onehot_gather.cu",
                    _TPU + "onehot_gather.py:119"),
    # no Pallas site: the fixed-order backwards of what JAX leaves to XLA's
    # autodiff, jax.image.resize "linear" (the encoder's upsampling) and the
    # interlevel loss's one-hot take in outer_measure
    "K1-bwd-upsample": (upsample_bilinear_bwd, upsample_bilinear_bwd_plain,
                        _CSRC + "upsample_bwd.cu",
                        "none (XLA autodiff of jax.image.resize, "
                        "neural_jacobian_field_tpu/models/encoder_resnet.py:289)"),
    "K1-bwd-small": (small_scatter, small_scatter_plain, _CSRC + "small_scatter.cu",
                     "none (XLA autodiff of outer_measure's one-hot take, "
                     "neural_jacobian_field_tpu/ops/losses.py:20)"),
    # no Pallas site: the Jacobian transformer's layer, which JAX leaves to
    # XLA (neural_jacobian_field_tpu/models/transformer.py), fused forward
    # and backward
    "JT-fwd": (attn_layer_fwd, attn_layer_fwd_plain, _CSRC + "attn_layer.cu",
               "none (XLA, neural_jacobian_field_tpu/models/transformer.py)"),
    "JT-bwd": (attn_layer_bwd, attn_layer_bwd_plain, _CSRC + "attn_layer.cu",
               "none (XLA autodiff, neural_jacobian_field_tpu/models/transformer.py)"),
}


def launch_counts() -> dict:
    return {name: k[0].launches for name, k in KERNELS.items()}


def legacy_launch_counts() -> dict:
    """Launches that went to a legacy kernel: the K9 wrappers' (C or Cout not
    a multiple of 8) and the K7 wrappers' (shapes off field_mlp.fwd_plan's
    or bwd_plan's wgmma kernels)."""
    return {name: k[0].legacy_launches for name, k in KERNELS.items()
            if hasattr(k[0], "legacy_launches")}


def reset_launch_counts() -> None:
    for wrapper, *_ in KERNELS.values():
        wrapper.launches = 0
        if hasattr(wrapper, "legacy_launches"):
            wrapper.legacy_launches = 0
