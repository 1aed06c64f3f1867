"""Metrics sinks and sanity telemetry (PyTorch counterpart of
utils/logging.py): scalars to the console and a JSONL stream
(<log_dir>/metrics.jsonl), and to wandb where a run is configured and the
library is installed; the min and max of every float tensor of a nested
structure, under the JAX package's names."""

import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, Optional

import torch


def _float_leaves(tree, prefix: str = ""):
    """(name, tensor) of every floating-point tensor in dataclasses, tuples,
    lists and dicts, named as JAX names pytree paths: the keys joined by
    "_"."""

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, torch.Tensor):
            if node.is_floating_point():
                yield prefix + "_".join(map(str, path)), node
        elif dataclasses.is_dataclass(node):
            for f in dataclasses.fields(node):
                yield from walk(getattr(node, f.name), path + [f.name])
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                yield from walk(v, path + [i])
        elif isinstance(node, dict):
            for k in sorted(node):
                yield from walk(node[k], path + [k])

    yield from walk(tree, [])


def get_sanity_metrics(tree, prefix: str = "") -> Dict[str, float]:
    """Min and max of every float tensor, as host floats."""
    return {k: float(v) for k, v in get_sanity_metrics_traced(tree, prefix).items()}


def get_sanity_metrics_traced(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Min and max of every float tensor as 0-d tensors on its device, read
    by nothing on the host (a captured train step carries them)."""
    out = {}
    for name, leaf in _float_leaves(tree, prefix):
        leaf = leaf.detach()
        out[f"{name}_min"] = leaf.amin()
        out[f"{name}_max"] = leaf.amax()
    return out


class MetricsLogger:
    """Console + JSONL scalar sink; optional wandb passthrough."""

    def __init__(self, log_dir: Optional[Path] = None, wandb_run=None, print_every: int = 100):
        self.log_dir = Path(log_dir) if log_dir else None
        self.print_every = print_every
        self.wandb_run = wandb_run
        self._fp = None
        if self.log_dir is not None:
            self.log_dir.mkdir(parents=True, exist_ok=True)
            self._fp = open(self.log_dir / "metrics.jsonl", "a", encoding="utf-8")
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float]):
        scalars = {k: float(v) for k, v in metrics.items()}
        if self._fp is not None:
            self._fp.write(json.dumps({"step": step, "t": time.time() - self._t0,
                                       **scalars}) + "\n")
            self._fp.flush()
        if self.wandb_run is not None:
            self.wandb_run.log(scalars, step=step)
        if step % self.print_every == 0:
            parts = " ".join(f"{k}={v:.5g}" for k, v in sorted(scalars.items())
                             if not k.startswith("sanity/"))
            print(f"[step {step}] {parts}", flush=True)

    def close(self):
        if self._fp is not None:
            self._fp.close()


def maybe_init_wandb(cfg) -> Optional[object]:
    """A wandb run when the mode is not "disabled" and wandb is installed;
    None otherwise."""
    if getattr(cfg, "mode", "disabled") == "disabled":
        return None
    try:
        import wandb
    except ImportError:
        print("wandb not installed; logging to JSONL only")
        return None
    return wandb.init(project=cfg.project, entity=cfg.entity, name=cfg.name,
                      group=cfg.group, tags=cfg.tags, mode=cfg.mode)
