"""Flax -> PyTorch weight bridge.

The port's modules carry the JAX param tree's names (encoder/layer1_block0/
conv1, decoder/density_head/blocks_0_fc_0, proposal_networks_0/...), so the
bridge is a leaf-by-leaf rename:
  Dense `kernel` [in, out]      -> `weight` [out, in] (nn.Linear)
  Conv  `kernel` HWIO           -> `weight` HWIO (the port's conv and K9 layout)
  norm  `scale` / `bias`        -> `weight` / `bias` (BatchNorm, GroupNorm,
                                   LayerNorm)
  a bare param (`BARE_PARAMS`: `jacobian_index_embedding`) -> the parameter
                                   of that name
  batch_stats `mean` / `var`    -> buffers `running_mean` / `running_var`
Inputs are the Flax trees as nested dicts of arrays (numpy, or anything
np.asarray takes); nothing here imports JAX.

`load_optax_adam_state` carries an optax Adam state (`ScaleByAdamState`:
mu, nu, count) over to the port's Adam (training/optim.py, which keeps
torch.optim.Adam's state layout), so a train state taken in the middle
of training computes the same next step on both sides; in stage 2 the state
covers the trainable partition of optax's multi_transform alone, as the
port's optimizer does.
"""

from typing import Dict, Optional

import numpy as np
import torch


# parameters a Flax module declares itself (self.param), kept by name
BARE_PARAMS = ("jacobian_index_embedding",)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def from_jax_variables(params, batch_stats: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """Flax `params` (+ `batch_stats`) -> a state_dict for the port's module
    of the same structure (load it with strict=True)."""
    state = {}
    for path, leaf in _flatten(params):
        *mods, name = path
        base = ".".join(mods)
        arr = np.asarray(leaf)
        if name == "kernel":
            state[f"{base}.weight"] = arr.T if arr.ndim == 2 else arr
        elif name == "scale":
            state[f"{base}.weight"] = arr
        elif name == "bias":
            state[f"{base}.bias"] = arr
        elif name in BARE_PARAMS:
            state[".".join(path)] = arr
        else:
            raise KeyError(f"unmapped param leaf {'/'.join(path)}")
    for path, leaf in _flatten(batch_stats or {}):
        *mods, name = path
        base = ".".join(mods)
        stat = {"mean": "running_mean", "var": "running_var"}.get(name)
        if stat is None:
            raise KeyError(f"unmapped batch_stats leaf {'/'.join(path)}")
        state[f"{base}.{stat}"] = np.asarray(leaf)
    # copies: JAX's arrays are read-only, torch's tensors are not
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in state.items()}


def _arrays_only(tree):
    """The tree without its non-array leaves (optax's MaskedNode stands for
    the leaves another partition of a multi_transform owns)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            sub = _arrays_only(v)
            if sub:
                out[k] = sub
        elif hasattr(v, "shape"):
            out[k] = v
    return out


def load_optax_adam_state(optimizer: torch.optim.Optimizer, model: torch.nn.Module,
                          *adam_states) -> None:
    """Set an Adam's per-parameter state (step, exp_avg, exp_avg_sq: the
    layout of torch.optim.Adam and of training/optim.Adam, which takes the
    count over at its next step) from optax ScaleByAdamStates (anything
    with .mu, .nu param-shaped trees and .count). Pass one state per optax partition that has one (one, or
    one per Adam-chained multi_transform label; set_to_zero's frozen
    partition has none); together they must cover exactly the parameters
    `optimizer` holds (`model` names them)."""
    held = {id(p) for group in optimizer.param_groups for p in group["params"]}
    params = {name: p for name, p in model.named_parameters() if id(p) in held}
    if len(params) != len(held):
        raise KeyError("the optimizer holds parameters that are not the model's")
    seen = set()
    for st in adam_states:
        mu = from_jax_variables(_arrays_only(st.mu))
        nu = from_jax_variables(_arrays_only(st.nu))
        count = float(np.asarray(st.count))
        for name, m in mu.items():
            p = params.get(name)
            if p is None:
                raise KeyError(f"Adam state for {name}, which the optimizer does not hold")
            optimizer.state[p] = {"step": torch.tensor(count),
                                  "exp_avg": m.to(p.device, p.dtype).clone(),
                                  "exp_avg_sq": nu[name].to(p.device, p.dtype).clone()}
            seen.add(name)
    missing = sorted(set(params) - seen)
    if missing:
        raise KeyError(f"no Adam state for {missing[:5]}{'...' if len(missing) > 5 else ''}")
