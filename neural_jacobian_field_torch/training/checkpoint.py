"""Checkpoints on torch.save / torch.load (PyTorch counterpart of
training/checkpoint.py, which is built on orbax):
  - `CheckpointManager` saves the full train state (model parameters and
    BatchNorm statistics, optimizer, step, steps_since_update) every
    `save_interval_steps` steps and keeps the last `max_to_keep`;
  - `load_params_only` restores parameters shape-tolerantly into a model's
    (the stage-2 warm start, with a fresh optimizer), `load_batch_stats` the
    BatchNorm running statistics.
Files are `ckpt_<step>.pt` in the directory, read back with
weights_only=True (tensors and plain containers only).
"""

import os
import re
from pathlib import Path
from typing import Dict, List, Optional

import torch

from .train import TrainState, merge_compatible_params

_NAME = re.compile(r"ckpt_(\d+)\.pt$")
_STATS = ("running_mean", "running_var")


def _steps(directory: Path) -> List[int]:
    return sorted(int(m.group(1)) for p in directory.iterdir()
                  if (m := _NAME.match(p.name)))


def _path(directory: Path, step: int) -> Path:
    return directory / f"ckpt_{step:09d}.pt"


def _read(directory, step: Optional[int]) -> dict:
    directory = Path(directory)
    steps = _steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    return torch.load(_path(directory, steps[-1] if step is None else step),
                      map_location="cpu", weights_only=True)


class CheckpointManager:
    def __init__(self, directory, max_to_keep: int = 3, save_interval_steps: int = 5000):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps

    def maybe_save(self, state: TrainState) -> bool:
        """Save when the step is a multiple of the interval; drop the oldest
        beyond max_to_keep. Returns whether it saved."""
        if state.step % self.save_interval_steps:
            return False
        path = _path(self.directory, state.step)
        tmp = path.with_suffix(".tmp")
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": state.step,
                    "steps_since_update": state.steps_since_update}, tmp)
        os.replace(tmp, path)
        for old in _steps(self.directory)[:-self.max_to_keep]:
            _path(self.directory, old).unlink()
        return True

    def latest_step(self) -> Optional[int]:
        steps = _steps(self.directory)
        return steps[-1] if steps else None

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Load a saved state (the latest by default) into `state`, in place."""
        ckpt = _read(self.directory, step)
        state.model.load_state_dict(ckpt["model"], strict=True)
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["step"])
        state.steps_since_update = int(ckpt["steps_since_update"])
        return state


def load_params_only(path, model: torch.nn.Module, step: Optional[int] = None,
                     report: Optional[list] = None) -> Dict[str, torch.Tensor]:
    """Restore only parameters from a checkpoint directory, shape-tolerantly
    merged into the model's (missing or mismatched entries keep the model's
    and are reported), and load them. Returns the merged parameters."""
    saved = _read(path, step)["model"]
    template = dict(model.named_parameters())
    merged = merge_compatible_params({k: v.detach() for k, v in template.items()},
                                     {k: v for k, v in saved.items() if not k.endswith(_STATS)},
                                     report)
    with torch.no_grad():
        for k, p in template.items():
            p.copy_(merged[k])
    return merged


def load_batch_stats(path, model: torch.nn.Module,
                     step: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Restore the BatchNorm running statistics (shape-tolerantly) into the
    model. Eval-mode BatchNorm reads these: rendering a batch-norm model with
    fresh statistics degrades it badly."""
    saved = _read(path, step)["model"]
    template = {k: v for k, v in model.state_dict().items() if k.endswith(_STATS)}
    merged = merge_compatible_params(template, {k: v for k, v in saved.items()
                                                if k.endswith(_STATS)})
    model.load_state_dict(merged, strict=False)
    return merged
