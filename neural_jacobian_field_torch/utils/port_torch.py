"""Reference PyTorch checkpoints -> the port's state dict (the counterpart
of the JAX package's utils/port_torch.py, with NumPy and torch only).

A reference Lightning checkpoint (`state_dict` with `model.`-prefixed keys
from neural_jacobian_field/models/model.py) maps straight onto the port's
module names, which are the Flax param tree's joined by dots:
  encoder.model.conv1/bn1/layerL.B.*       -> encoder.conv1, bn1, layerL_blockB.*
                                              (downsample.0 / .1 ->
                                              downsample_conv / downsample_norm)
  <trunk>.lin_in|lin_z.N|blocks.N.fc_0|fc_1|lin_out
                                           -> <trunk>.lin_in, lin_z_N,
                                              blocks_N_fc_0, blocks_N_fc_1, lin_out
  decoder.color_head.{0,2,4}               -> decoder.color_head.fc{1,2,3}
  decoder.jacobian_index_embedding         -> the same bare parameter
  decoder.jacobian_query_mlp               -> the same linear
  decoder.jacobian_attn_decoder.layers.N.{0,1}.{norm,fn.*}
                                           -> decoder.jacobian_attn_decoder.layers_N_*
  proposal_networks.N.density_head.*       -> proposal_networks_N.density_head.*

Layouts: an nn.Linear weight stays [out, in] (torch's, the port's); a conv
weight [out, in, kh, kw] goes to the port's HWIO [kh, kw, in, out];
BatchNorm weight / bias are parameters, its running statistics buffers.
"""

import pickle
from typing import Dict, List, Tuple

import numpy as np
import torch

_STATS = ("running_mean", "running_var")


def _lin(sd, src, dst, out):
    out[f"{dst}.weight"] = sd[f"{src}.weight"]
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = sd[f"{src}.bias"]


def _conv(sd, src, dst, out):
    out[f"{dst}.weight"] = sd[f"{src}.weight"].transpose(2, 3, 1, 0)
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = sd[f"{src}.bias"]


def _norm(sd, src, dst, out):
    for name in ("weight", "bias") + _STATS:
        if f"{src}.{name}" in sd:
            out[f"{dst}.{name}"] = sd[f"{src}.{name}"]


def _resnet_fc(sd, src, dst, out):
    """model_components/resnet_fc.py:97-123 -> models/resnet_fc.py."""
    _lin(sd, f"{src}.lin_in", f"{dst}.lin_in", out)
    _lin(sd, f"{src}.lin_out", f"{dst}.lin_out", out)
    n = 0
    while f"{src}.blocks.{n}.fc_0.weight" in sd:
        _lin(sd, f"{src}.blocks.{n}.fc_0", f"{dst}.blocks_{n}_fc_0", out)
        _lin(sd, f"{src}.blocks.{n}.fc_1", f"{dst}.blocks_{n}_fc_1", out)
        n += 1
    n = 0
    while f"{src}.lin_z.{n}.weight" in sd:
        _lin(sd, f"{src}.lin_z.{n}", f"{dst}.lin_z_{n}", out)
        n += 1


def _encoder(sd, src, dst, out):
    """models/encoder/encoder_resnet.py (torchvision resnet34 layout)."""
    _conv(sd, f"{src}.conv1", f"{dst}.conv1", out)
    _norm(sd, f"{src}.bn1", f"{dst}.bn1", out)
    for layer_idx, num_blocks in ((1, 3), (2, 4), (3, 6), (4, 3)):
        for b in range(num_blocks):
            base = f"{src}.layer{layer_idx}.{b}"
            if f"{base}.conv1.weight" not in sd:
                continue
            d = f"{dst}.layer{layer_idx}_block{b}"
            _conv(sd, f"{base}.conv1", f"{d}.conv1", out)
            _conv(sd, f"{base}.conv2", f"{d}.conv2", out)
            _norm(sd, f"{base}.bn1", f"{d}.bn1", out)
            _norm(sd, f"{base}.bn2", f"{d}.bn2", out)
            if f"{base}.downsample.0.weight" in sd:
                _conv(sd, f"{base}.downsample.0", f"{d}.downsample_conv", out)
                _norm(sd, f"{base}.downsample.1", f"{d}.downsample_norm", out)


def _transformer(sd, src, dst, out):
    """model_components/transformer.py:87-135 (PreNorm-wrapped layers:
    layers.i.0 = PreNorm(Attention), layers.i.1 = PreNorm(FeedForward))."""
    i = 0
    while f"{src}.layers.{i}.0.norm.weight" in sd:
        _norm(sd, f"{src}.layers.{i}.0.norm", f"{dst}.layers_{i}_attn_norm", out)
        attn, a = f"{src}.layers.{i}.0.fn", f"{dst}.layers_{i}_attn"
        if f"{attn}.to_qkv.weight" in sd:
            _lin(sd, f"{attn}.to_qkv", f"{a}.to_qkv", out)
        else:
            _lin(sd, f"{attn}.to_q", f"{a}.to_q", out)
            _lin(sd, f"{attn}.to_kv", f"{a}.to_kv", out)
        if f"{attn}.to_out.0.weight" in sd:
            _lin(sd, f"{attn}.to_out.0", f"{a}.to_out", out)
        _norm(sd, f"{src}.layers.{i}.1.norm", f"{dst}.layers_{i}_ff_norm", out)
        ff = f"{src}.layers.{i}.1.fn.net"
        _lin(sd, f"{ff}.0", f"{dst}.layers_{i}_ff.fc1", out)
        _lin(sd, f"{ff}.3", f"{dst}.layers_{i}_ff.fc2", out)
        i += 1


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def port_reference_checkpoint(state_dict, strip_prefix: str = "model.") -> Dict[str, torch.Tensor]:
    """A reference state_dict (tensors or arrays) -> the port's state dict
    for the model of the same structure: float32 tensors, parameters and
    BatchNorm running statistics (`is_stat` tells them apart)."""
    sd = {(k[len(strip_prefix):] if k.startswith(strip_prefix) else k): _host(v)
          for k, v in state_dict.items()}
    out: dict = {}
    _encoder(sd, "encoder.model", "encoder", out)
    n = 0
    while any(k.startswith(f"proposal_networks.{n}.") for k in sd):
        _resnet_fc(sd, f"proposal_networks.{n}.density_head",
                   f"proposal_networks_{n}.density_head", out)
        n += 1
    _resnet_fc(sd, "decoder.density_head", "decoder.density_head", out)
    for head in ("jacobian_head", "jacobian_head_arm", "flow_head", "flow_head_arm"):
        if f"decoder.{head}.lin_in.weight" in sd:
            _resnet_fc(sd, f"decoder.{head}", f"decoder.{head}", out)
    if "decoder.jacobian_head.weight" in sd:  # the transformer's plain Linear head
        _lin(sd, "decoder.jacobian_head", "decoder.jacobian_head", out)
    if "decoder.jacobian_index_embedding" in sd:
        out["decoder.jacobian_index_embedding"] = sd["decoder.jacobian_index_embedding"]
        _lin(sd, "decoder.jacobian_query_mlp", "decoder.jacobian_query_mlp", out)
        _transformer(sd, "decoder.jacobian_attn_decoder", "decoder.jacobian_attn_decoder",
                     out)
    # colour head: Sequential(Linear, ReLU, Linear, ReLU, Linear, Sigmoid)
    for torch_idx, name in ((0, "fc1"), (2, "fc2"), (4, "fc3")):
        if f"decoder.color_head.{torch_idx}.weight" in sd:
            _lin(sd, f"decoder.color_head.{torch_idx}", f"decoder.color_head.{name}", out)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in out.items()}


def is_stat(key: str) -> bool:
    """Whether a state-dict key is a BatchNorm running statistic."""
    return key.endswith(_STATS)


def merge_reference_state(model: torch.nn.Module, ported: Dict[str, torch.Tensor]
                          ) -> Tuple[int, List[str]]:
    """Load the ported entries whose name and shape the model has, in place
    (model_wrapper.py:553-573's shape-tolerant load); the rest keep the
    model's. Returns (parameters loaded, ported keys skipped), both counted
    over parameters, the running statistics aside, as the JAX loader counts."""
    state = model.state_dict()
    matched, skipped = 0, []
    for k, v in ported.items():
        if k in state and state[k].shape == v.shape:
            state[k] = v
            matched += not is_stat(k)
        elif not is_stat(k):
            skipped.append(k)
    model.load_state_dict(state, strict=True)
    return matched, skipped


def load_torch_state_dict(path) -> Dict[str, torch.Tensor]:
    """The tensors of a torch weight file: a plain state_dict, or a
    Lightning checkpoint's "state_dict". Read with weights_only first; a
    Lightning checkpoint that holds other objects needs the full unpickler
    (open only files you trust)."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return {k: v for k, v in sd.items() if torch.is_tensor(v) or hasattr(v, "shape")}


def load_reference_checkpoint(path, model: torch.nn.Module) -> Tuple[int, List[str]]:
    """Load a reference .ckpt / .pt file into `model` in place. Returns and
    prints the number of parameters ported and the skipped keys."""
    sd = load_torch_state_dict(path)
    matched, skipped = merge_reference_state(model, port_reference_checkpoint(sd))
    print(f"ported {matched} tensors; skipped {len(skipped)}")
    if skipped:
        print("  e.g.", skipped[:5])
    return matched, skipped
