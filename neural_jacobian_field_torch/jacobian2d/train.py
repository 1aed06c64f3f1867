"""The 2D pipeline's train step (PyTorch counterpart of jacobian2d/train.py):
loss = MSE(J(image) @ command, flow), then optax's Adam chain.

The update follows optax's order (training/optim.Adam): the decayed weights
added to the gradient before Adam (L2, not AdamW), Adam (b1 0.9, b2 0.999,
eps 1e-8), the linear warm-up schedule read at the count before the step.
The transformer model's `dino` parameters are frozen: the optimizer does not
hold them (optax's multi_transform with set_to_zero: no update, no decay)
and they take no gradient.

`make_train_step_2d` returns the step as a device program: on the card it is
captured as a CUDA graph at its first call and replayed after (the
counterpart of JAX's `jax.jit(donate_argnums=0)`, inference/programs.py:
parameters and Adam's state updated in place, the batch through static
buffers, the loss back as a copy); on the CPU, and inside
`model.programs.eager()`, the same Python runs eagerly. Its forward and
backward run under cuDNN's deterministic algorithms and the UNet's pool
backward is elementwise, so a step repeats bit for bit.
"""

from dataclasses import dataclass, field
from typing import Dict, List

import torch
from torch import nn

from ..inference.programs import ProgramCache
from ..ops.deterministic import deterministic_cudnn
from ..training.optim import Adam

BATCH_KEYS = ("input_frame_curr", "input_command", "trgt_flow_curr")


@dataclass(frozen=True)
class Train2DCfg:
    lr: float = 1e-4
    weight_decay: float = 1e-5
    warm_up_steps: int = 1000


@dataclass
class TrainState2D:
    """The model (its parameters updated in place), its optimizer, the
    config and the host's step count."""

    model: nn.Module
    optimizer: Adam
    cfg: Train2DCfg
    step: int = 0
    frozen: List[str] = field(default_factory=list)


def trainable_params_2d(model: nn.Module):
    """(trainable, frozen) parameter names: every parameter under a `dino`
    module is frozen (optax's mask: "dino" in the param path)."""
    names = [n for n, _ in model.named_parameters()]
    frozen = [n for n in names if "dino" in n.split(".")]
    return [n for n in names if n not in frozen], frozen


def make_optimizer_2d(cfg: Train2DCfg, model: nn.Module) -> Adam:
    """Adam over the trainable parameters (optax's linear_schedule with 0
    transition steps is the constant lr: one step of lr / 1 to lr is the
    same)."""
    trainable, _ = trainable_params_2d(model)
    params = dict(model.named_parameters())
    return Adam([params[n] for n in trainable], lr=cfg.lr,
                warm_up_steps=max(cfg.warm_up_steps, 1), weight_decay=cfg.weight_decay)


def programs_of(model: nn.Module) -> ProgramCache:
    """The model's captured programs (made at first use)."""
    if getattr(model, "programs", None) is None:
        model.programs = ProgramCache()
    return model.programs


def create_train_state_2d(model: nn.Module, cfg: Train2DCfg) -> TrainState2D:
    """The train state of an initialised model (seeded, or loaded): the
    frozen parameters take no gradient, Adam's state starts at zero."""
    _, frozen = trainable_params_2d(model)
    params = dict(model.named_parameters())
    for n in frozen:
        params[n].requires_grad_(False)
    programs_of(model)
    opt = make_optimizer_2d(cfg, model)
    opt.prepare()
    return TrainState2D(model=model, optimizer=opt, cfg=cfg, frozen=frozen)


def _step_body(model: nn.Module, opt: Adam, img, cmd, flow):
    """One step's device work: nothing in it reads a value back to the host."""
    opt.zero_grad(set_to_none=True)
    with deterministic_cudnn():
        out = model(img, cmd)
        loss = torch.mean((out.flow - flow) ** 2)
        loss.backward()
    for p in opt.params():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    opt.step()
    return (loss.detach(),)


def batch_tensors(batch: Dict, device) -> tuple:
    """The step's inputs from a collated batch (numpy or tensors) on the
    model's device, in their own float dtype (the dataset's float32):
    image [B, H, W, 3], command [B, C], flow [B, H, W, S]."""
    return tuple(torch.as_tensor(batch[k], device=device) for k in BATCH_KEYS)


def make_train_step_2d(model: nn.Module, cfg: Train2DCfg):
    """(state, batch) -> {"train/loss": 0-d tensor}, the state updated in
    place; a captured program on the card (see the module's docstring)."""

    def step(state: TrainState2D, batch: Dict) -> Dict[str, torch.Tensor]:
        if state.model is not model or state.cfg != cfg:
            raise ValueError("make_train_step_2d: the state is not of this model and config")
        opt = state.optimizer
        dev = next(model.parameters()).device
        inputs = batch_tensors(batch, dev)
        key = (_step_body, model, opt, opt.hyperparameters())
        writes = [*model.parameters(), *model.buffers(), *opt.state_tensors()]
        (loss,) = programs_of(model).run(key, inputs, lambda *ts: _step_body(model, opt, *ts),
                                         writes=writes, pool="train2d")
        state.step += 1
        return {"train/loss": loss}

    return step
