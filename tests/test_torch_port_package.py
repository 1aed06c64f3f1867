"""Package-level properties of the PyTorch port: it imports no JAX, its
configuration defaults equal the JAX package's, the flagship configuration
is what the repo trains and benches, and its seeded initialiser draws the
JAX package's distributions."""

import dataclasses
import importlib
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_BLOCK_JAX = r"""
import importlib, pkgutil, sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "neural_jacobian_field_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, _Block())
for mod in ("jax", "flax"):
    sys.modules[mod] = None
import neural_jacobian_field_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                                     "neural_jacobian_field_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
print(" ".join(names))
print(len(names))
"""

# the modules of the training CLI's slice: config, data pipeline, prefetch,
# utilities, validation videos, the CLI and the e2e drive
CLI_MODULES = (
    "config", "config.common", "config.tools", "data",
    "data.augmentation", "data.conventions", "data.dataparser", "data.dataset",
    "data.image_io", "data.loader", "data.native", "data.synthetic", "ops.grid_sample",
    "parallel", "parallel.prefetch", "utils.logging", "utils.metrics", "utils.profiling",
    "visualization", "visualization.validation", "visualization.view_interpolation", "train",
    "verify_e2e")

# the inference toolbox and the flow helper: compositing, sensitivity maps,
# loaders, the overlays, reference checkpoints, RAFT, the ingest CLI
TOOLS_MODULES = (
    "ops", "ops.compositing", "inference", "inference.sensitivity", "inference.loaders",
    "utils.device", "utils.port_torch", "utils.from_jax", "flow", "flow.raft", "ingest")


def test_port_imports_without_jax():
    """Every module of the port imports with JAX, flax and the JAX package
    blocked (a fresh interpreter: this one has JAX loaded)."""
    out = subprocess.run([sys.executable, "-c", _BLOCK_JAX], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    *_, listed, count = out.stdout.strip().splitlines()
    assert int(count) >= 20
    imported = set(listed.split())
    missing = [m for m in CLI_MODULES + TOOLS_MODULES
               if f"neural_jacobian_field_torch.{m}" not in imported]
    assert not missing, missing


def _fields(cls):
    return {f.name: (f.default if f.default is not dataclasses.MISSING
                     else f.default_factory()) for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("name,jax_mod,torch_mod", [
    ("RenderingCfg", "models.model", "models.model"),
    ("ModelCfg", "models.model", "models.model"),
    ("EncoderResnetCfg", "models.encoder_resnet", "models.encoder_resnet"),
    ("MlpCfg", "models.resnet_fc", "models.resnet_fc"),
    ("DensityDecoderMlpCfg", "models.decoders", "models.decoders"),
    ("ActionDecoderJacobianMlpCfg", "models.decoders", "models.decoders"),
])
def test_config_defaults_match_jax(name, jax_mod, torch_mod):
    jcls = getattr(importlib.import_module(f"neural_jacobian_field_tpu.{jax_mod}"), name)
    tcls = getattr(importlib.import_module(f"neural_jacobian_field_torch.{torch_mod}"), name)
    jf, tf = _fields(jcls), _fields(tcls)
    assert list(jf) == list(tf)
    for k in jf:
        if dataclasses.is_dataclass(jf[k]):
            assert dataclasses.asdict(jf[k]) == dataclasses.asdict(tf[k]), k
        else:
            assert jf[k] == tf[k], k


def test_flagship_cfg_is_the_benched_model():
    """bench.py:_flagship_model + model_allegro.yaml, field by field."""
    from neural_jacobian_field_torch.models.model import flagship_model_cfg

    cfg = flagship_model_cfg()
    r, e = cfg.rendering, cfg.encoder
    assert (r.num_proposal_samples, r.num_nerf_samples) == ((256,), 256)
    assert (r.pixel_feature_mode, r.epipolar_knots) == ("epipolar", (64, 16, 8))
    assert r.use_fused_trunk and r.use_pallas_pdf
    assert (e.norm_type, e.feature_layout, e.num_layers, e.conv_impl) == (
        "batch", "pyramid", 4, "pallas")
    assert cfg.action_decoder.name == "jacobian_mlp" and cfg.action_dim == 8
    mlp = cfg.action_decoder.mlp
    assert (mlp.n_blocks, mlp.d_hidden, mlp.combine_layer) == (5, 128, 3)
    assert cfg.density_decoder.mlp == mlp


def test_seeded_init_draws_the_jax_distributions():
    from neural_jacobian_field_torch.models.model import Model, flagship_model_cfg

    m = Model(flagship_model_cfg()).init_weights(torch.Generator().manual_seed(0))
    sd = m.state_dict()
    # encoder convs: N(0, 2 / fan_out), fan_out = kh * kw * cout
    w = sd["encoder.layer2_block1.conv1.weight"]
    assert abs(w.std().item() - math.sqrt(2 / (9 * 128))) < 0.02 * math.sqrt(2 / (9 * 128))
    assert torch.equal(sd["encoder.bn1.weight"], torch.ones(64))
    assert torch.equal(sd["encoder.bn1.running_var"], torch.ones(64))
    # ResnetFC: kaiming-normal fan_in, zero second block linear
    d = "decoder.density_head"
    w = sd[f"{d}.lin_z_0.weight"]
    assert abs(w.std().item() - math.sqrt(2 / 512)) < 0.02 * math.sqrt(2 / 512)
    assert not sd[f"{d}.blocks_0_fc_1.weight"].any()
    # Jacobian head: N(0, 1e-4) on every linear, biases included
    j = [v for k, v in sd.items() if k.startswith("decoder.jacobian_head.")]
    assert all(v.abs().max().item() < 1e-3 for v in j) and all(v.std() > 0 for v in j)
    # colour head: U(+-sqrt(1 / fan_in))
    c = sd["decoder.color_head.fc2.weight"]
    assert c.abs().max().item() <= 1 / 8 and c.abs().max().item() > 0.9 / 8
    # seeded: the same generator seed gives the same weights
    m2 = Model(flagship_model_cfg()).init_weights(torch.Generator().manual_seed(0))
    assert all(torch.equal(v, m2.state_dict()[k]) for k, v in sd.items())


def test_bridge_maps_layouts():
    from neural_jacobian_field_torch.utils.from_jax import from_jax_variables
    import numpy as np

    params = {"enc": {"conv": {"kernel": np.zeros((3, 3, 2, 4))},
                      "bn": {"scale": np.ones(4), "bias": np.zeros(4)}},
              "head": {"lin": {"kernel": np.arange(6.0).reshape(2, 3), "bias": np.ones(3)}}}
    stats = {"enc": {"bn": {"mean": np.zeros(4), "var": np.ones(4)}}}
    sd = from_jax_variables(params, stats)
    assert sd["enc.conv.weight"].shape == (3, 3, 2, 4)
    assert torch.equal(sd["head.lin.weight"], torch.arange(6.0).reshape(2, 3).T)
    assert set(sd) == {"enc.conv.weight", "enc.bn.weight", "enc.bn.bias", "head.lin.weight",
                       "head.lin.bias", "enc.bn.running_mean", "enc.bn.running_var"}
    with pytest.raises(KeyError):
        from_jax_variables({"x": {"embedding": np.zeros(2)}})
