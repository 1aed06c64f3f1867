"""Train state, optimizer and the train steps of both stages (PyTorch
counterpart of training/train.py).

The optimizer is optax's chain in tensor ops (training/optim.py): Adam with
weight decay 1e-5 added to the gradient before the moments, and the linear
warmup lr/warmup -> lr read at the step count before the step, a 0-d device
tensor. `grad_clip_norm` clips by the global norm with optax's formula (g *
max / ||g|| unless ||g|| < max), on the device; `encoder_lr_scale` gives the
encoder its own parameter group (stage 1 only: the JAX package ignores it
in stage 2).

Every parameter the optimizer holds takes an Adam step, reached by the loss
or not: optax decays and normalises a zero gradient too (the Jacobian head
in stage 1, the proposal networks on frozen steps), so the port fills zeros
where autograd left a gradient of None. Stage 2 (`TrainCfg.mode="action"`)
trains only the decoder's action parameters (`trainable_mask`, the JAX optax
multi_transform): the optimizer holds those alone, so the frozen ones are
neither decayed nor moved (optax's set_to_zero), and they get
requires_grad=False, so autograd records no encoder, proposal or density
backward (the JAX `stop_frozen_gradients`). The forward still runs in
training mode: the BatchNorm running statistics move in stage 2 as the JAX
step's mutable batch_stats do. A stage-1 step renders no optical flow: no
loss of that stage reads it, so the Jacobian trunk is not evaluated (XLA
deletes it from the JAX step).

The host keeps the step and the proposal sampler's update counter as Python
ints (`TrainState.step`, `steps_since_update`) and decides the proposal
gate from them (`host_step_schedule`), as the JAX train loop does; on a
frozen step the proposal density runs under no_grad and takes no backward.
The anneal exponent is computed on the device from the optimizer's count.

The steps as device programs: as the JAX package compiles one program per
gate value (`make_train_step(static_updated=...)`) and K steps per dispatch
(`make_multi_train_step`, picked per recurring gate tuple by
`MultiStepDispatch`), the port captures each as a CUDA graph on the card
(inference/programs.py) and replays it: the batch, the pixel set and the
stratified draws enter through static buffers (the randomness is drawn
outside the graph, from the step's generator); parameters, BatchNorm
statistics and Adam's state are read and written in place and key the
program (reassigned, they make it be captured again; the warm-up calls
before a capture leave them as they were); the gradients live in the
program's memory pool, which the train programs of a model share; the
metrics come back as copies. On the CPU, and inside `model.programs.eager()`,
the same Python runs eagerly: `train_step` is that body.

A step repeats bit for bit on the card, as the JAX step does on the CPU or
the TPU: its forward and backward run under cuDNN's deterministic
algorithms (`ops/deterministic.deterministic_cudnn`, for the step alone),
the gathers and the encoder's upsampling take fixed-order backwards, and
the stem's max-pool keeps PyTorch's, which gathers (no atomic sums).
"""

from dataclasses import dataclass, field, fields
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..models.decoders import action_param_pattern
from ..models.model import Model, StepCtx, step_anneal, step_schedules
from ..ops.deterministic import deterministic_cudnn
from .losses import LossCfg, action_loss, perception_loss
from .optim import Adam
from .prepare import RawBatch, prepare_training_batch, sample_pixels


@dataclass(frozen=True)
class TrainCfg:
    mode: str = "perception"  # perception | action
    lr: float = 1e-4
    weight_decay: float = 1e-5
    warm_up_steps: int = 10000
    rays_per_batch: int = 256
    loss: LossCfg = field(default_factory=LossCfg)
    grad_clip_norm: Optional[float] = None  # global-norm clipping, before decay
    encoder_lr_scale: float = 1.0  # stage-1 lr multiplier on encoder.* parameters


@dataclass
class TrainState:
    model: Model
    optimizer: Adam
    cfg: TrainCfg
    step: int = 0
    steps_since_update: int = 0  # the proposal sampler's update counter


def trainable_mask(model: torch.nn.Module, mode: str, action_decoder_cfg) -> Dict[str, str]:
    """Parameter name -> "trainable" or "frozen". Stage 2 ("action") trains
    only the decoder parameters whose name has a part containing the
    decoder's action pattern (the JAX mask over param paths); stage 1 trains
    everything."""
    if mode not in ("perception", "action"):
        raise ValueError(f"unknown mode {mode!r}")
    labels = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        trainable = mode == "perception" or (
            parts[0] == "decoder"
            and any(action_param_pattern(action_decoder_cfg) in part for part in parts))
        labels[name] = "trainable" if trainable else "frozen"
    return labels


def make_optimizer(cfg: TrainCfg, model: Model) -> Adam:
    """Adam(wd) with the warmup schedule. Stage 1: two groups, "encoder" (lr
    x encoder_lr_scale) and "other". Stage 2: one group of the trainable
    parameters; the frozen ones get requires_grad=False. Each group's
    "lr_mult" scales the warmup schedule."""
    if cfg.mode == "action":
        labels = trainable_mask(model, cfg.mode, model.cfg.action_decoder)
        params = []
        for name, p in model.named_parameters():
            p.requires_grad_(labels[name] == "trainable")
            if p.requires_grad:
                params.append(p)
        groups = [dict(params=params, name="trainable", lr_mult=1.0)]
    else:
        enc, other = [], []
        for name, p in model.named_parameters():
            (enc if name.startswith("encoder.") else other).append(p)
        groups = [dict(params=enc, name="encoder", lr_mult=cfg.encoder_lr_scale),
                  dict(params=other, name="other", lr_mult=1.0)]
    return Adam(groups, lr=cfg.lr, warm_up_steps=cfg.warm_up_steps,
                weight_decay=cfg.weight_decay, betas=(0.9, 0.999), eps=1e-8)


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place, on the device: g <- (g / ||g||) *
    max_norm unless ||g|| < max_norm. Returns the norm."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep, one = norm < max_norm, torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(norm, max_norm)))
    return norm


def merge_compatible_params(template: Dict[str, torch.Tensor],
                            loaded: Dict[str, torch.Tensor],
                            report: Optional[list] = None) -> Dict[str, torch.Tensor]:
    """Shape-tolerant warm start over state dicts: keep the `loaded` entries
    whose name and shape match `template`, keep the template's elsewhere.
    Prints a kept/dropped summary and a (name, reason) line per mismatch,
    also appended to `report` when given, and warns when nothing matched."""
    merged, kept, details = {}, 0, []
    for k, v in template.items():
        lv = loaded.get(k)
        if lv is not None and tuple(lv.shape) == tuple(v.shape):
            merged[k] = lv
            kept += 1
        else:
            merged[k] = v
            details.append((k, "missing from checkpoint" if lv is None else
                            f"shape mismatch ckpt{tuple(lv.shape)} vs model{tuple(v.shape)}"))
    details += [(k, "not in model (dropped)") for k in loaded if k not in template]
    if report is not None:
        report.extend(details)
    print(f"warm start: kept {kept}/{len(template)} model params from checkpoint"
          f" ({len(details)} mismatches)")
    for name, reason in details:
        print(f"  warm start skip: {name}: {reason}")
    if kept == 0 and template:
        print("WARNING: warm start matched NOTHING — training from scratch; "
              "check that the checkpoint belongs to this model config")
    return merged


def create_train_state(model: Model, cfg: TrainCfg,
                       init_params: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
    """A fresh optimizer over the model's (already initialised) parameters.
    `init_params` (a state dict, running statistics included) warm-starts
    the model shape-tolerantly, with the fresh optimizer state ("so that
    optimization restarts"): stage 2 from a stage-1 model."""
    if init_params is not None:
        current = model.state_dict()
        model.load_state_dict(merge_compatible_params(current, init_params), strict=True)
    return TrainState(model=model, optimizer=make_optimizer(cfg, model), cfg=cfg)




def host_step_schedule(step: int, steps_since_update: int, rendering_cfg):
    """The proposal gate on the host: (updated, new_steps_since_update)."""
    _, updated, new_ssu = step_schedules(step, steps_since_update, rendering_cfg)
    return updated, new_ssu


def step_gate(state: TrainState, updated: Optional[bool] = None) -> Tuple[bool, int]:
    """The proposal gate of the state's next step and the update counter
    after it: the schedule's, or `updated` as given (the JAX static gate:
    the counter restarts at 1 after an update step, else counts on)."""
    if updated is None:
        return host_step_schedule(state.step, state.steps_since_update,
                                  state.model.cfg.rendering)
    return bool(updated), 1 if updated else state.steps_since_update + 1


def step_randomness(state: TrainState, batch: RawBatch,
                    generator: Optional[torch.Generator] = None,
                    yx: Optional[torch.Tensor] = None,
                    draws: Optional[Sequence[torch.Tensor]] = None):
    """A step's randomness, drawn on the batch's device from `generator`
    where it is not given, in the order the samplers would draw it: the
    shared pixel set yx [R, 2] (None where tracks choose the pixels), then
    each sampling level's stratified jitter in [0, 1) (the spaced sample's,
    then each resample's) [B, R, S + 1], or [B, R, 1] with single_jitter.
    Returns (yx, draws)."""
    b, h, w = batch.trgt_rgb.shape[:3]
    dev = batch.trgt_rgb.device
    tracks = state.cfg.mode == "action" and batch.pixel_selector is not None
    if yx is None and not tracks:
        yx = sample_pixels(state.cfg.rays_per_batch, h, w, generator, dev)
    if draws is None:
        rays = batch.pixel_selector.shape[1] if tracks else yx.shape[0]
        rcfg = state.model.cfg.rendering
        draws = [torch.rand((b, rays, 1 if rcfg.single_jitter else s + 1),
                            generator=generator, device=dev)
                 for s in (*rcfg.num_proposal_samples, rcfg.num_nerf_samples)]
    return yx, tuple(draws)


def _advance(state: TrainState, gates: Sequence[bool]) -> None:
    """The host's step and update counter after steps with these gates."""
    for updated in gates:
        _, state.steps_since_update = step_gate(state, updated)
        state.step += 1


def train_step(state: TrainState, batch: RawBatch,
               generator: Optional[torch.Generator] = None,
               updated: Optional[bool] = None, *, yx: Optional[torch.Tensor] = None,
               draws: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """One eager step of the state's stage: prepare the batch, forward in
    training mode, the perception or action loss, backward, Adam; the state
    advances in place. `updated` fixes the proposal gate (None: the
    schedule's); the pixel set (unless tracks choose the pixels) and the
    stratified draws are `yx` and `draws`, or drawn from `generator`
    (`step_randomness`). Returns the loss metrics (detached)."""
    upd, _ = step_gate(state, updated)
    yx, draws = step_randomness(state, batch, generator, yx, draws)
    metrics = _device_step(state.model, state.optimizer, state.cfg, batch, upd, yx, draws)
    _advance(state, (upd,))
    return metrics


def _device_step(model: Model, opt: Adam, cfg: TrainCfg, batch: RawBatch, updated: bool,
                 yx: Optional[torch.Tensor], draws: Sequence[torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """The device work of one step, what a train program captures: nothing
    in it reads a value back to the host or touches the host's counters."""
    mi, mt = prepare_training_batch(batch, cfg.rays_per_batch, yx=yx, mode=cfg.mode)
    ctx = StepCtx(anneal=step_anneal(opt.prepare(), model.cfg.rendering), updated=updated,
                  draws=tuple(draws), render_flow=cfg.mode == "action")
    opt.zero_grad(set_to_none=True)
    with deterministic_cudnn():  # the convolutions' backward without atomics
        out = model(mi, train=True, ctx=ctx)
        loss_fn = perception_loss if cfg.mode == "perception" else action_loss
        loss, metrics = loss_fn(out, mt, cfg.loss)
        loss.backward()
    _apply_gradients(opt, cfg)
    return metrics


def apply_gradients(state: TrainState) -> None:
    """The optimizer half of a step, on the gradients in the parameters'
    .grad: zeros where there is none, global-norm clipping, Adam at the
    count's warmup learning rate; then step += 1."""
    _apply_gradients(state.optimizer, state.cfg)
    state.step += 1


def _apply_gradients(opt: Adam, cfg: TrainCfg) -> None:
    params = opt.params()
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if cfg.grad_clip_norm is not None:
        with torch.no_grad():
            clip_by_global_norm_([p.grad for p in params], cfg.grad_clip_norm)
    opt.step()


# ------------------------------------------------------------ the programs

_BATCH_FIELDS = tuple(f.name for f in fields(RawBatch))


def _program_inputs(batch: RawBatch, yx, draws) -> Tuple[tuple, tuple]:
    """(names, tensors) of what a train program takes: the batch's leaves
    that are present, yx where there is one, then the draws."""
    named = [(n, getattr(batch, n)) for n in _BATCH_FIELDS if getattr(batch, n) is not None]
    if yx is not None:
        named.append(("yx", yx))
    named += [(f"draw{i}", d) for i, d in enumerate(draws)]
    return tuple(n for n, _ in named), tuple(t for _, t in named)


def _steps_program(model: Model, opt: Adam, cfg: TrainCfg, gates: Tuple[bool, ...],
                   stacked: bool, names: tuple, *tensors):
    """The body of a train program: len(gates) steps, step i on the i-th
    entry of each input when `stacked`, else one step on the inputs as
    they are. Returns (metric names, *metrics), each metric [K] when
    stacked, else 0-d."""
    given = dict(zip(names, tensors))
    n_draws = sum(n.startswith("draw") for n in names)
    steps = []
    for i, updated in enumerate(gates):
        at = {n: (t[i] if stacked else t) for n, t in given.items()}
        batch = RawBatch(**{n: at[n] for n in _BATCH_FIELDS if n in at})
        draws = [at[f"draw{j}"] for j in range(n_draws)]
        steps.append(_device_step(model, opt, cfg, batch, updated, at.get("yx"), draws))
    keys = tuple(sorted(steps[0]))
    if not stacked:
        return (keys, *(steps[0][k] for k in keys))
    return (keys, *(torch.stack([m[k] for m in steps]) for k in keys))


def _run_program(state: TrainState, gates: Tuple[bool, ...], stacked: bool, batch: RawBatch,
                 yx, draws) -> Dict[str, torch.Tensor]:
    """The steps through the model's program for these gates (captured at
    its first call, replayed after), or eagerly where the model's programs
    do not capture; then the host's counters advance."""
    model, opt, cfg = state.model, state.optimizer, state.cfg
    names, tensors = _program_inputs(batch, yx, draws)
    key = (_steps_program, model, opt, cfg, gates, stacked, names, opt.hyperparameters())
    writes = [*model.parameters(), *model.buffers(), *opt.state_tensors()]
    keys, *values = model.programs.run(
        key, tensors, lambda *ts: _steps_program(model, opt, cfg, gates, stacked, names, *ts),
        writes=writes, pool="train")
    _advance(state, gates)
    return dict(zip(keys, values))


def make_train_step(model: Model, cfg: TrainCfg, static_updated: Optional[bool] = None):
    """One train step as a device program: a callable (state, batch, yx=None,
    draws=None, generator=None) -> metrics for states of `model` and `cfg`.
    `static_updated` bakes the proposal gate in (None: the schedule's gate
    of each call, and a program per gate value). The randomness not given
    is drawn from `generator` outside the program (`step_randomness`)."""

    def step(state: TrainState, batch: RawBatch, yx=None, draws=None,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        if state.model is not model or state.cfg != cfg:
            raise ValueError("make_train_step: the state is not of this model and config")
        updated, _ = step_gate(state, static_updated)
        yx, draws = step_randomness(state, batch, generator, yx, draws)
        return _run_program(state, (updated,), False, batch, yx, draws)

    return step


def make_multi_train_step(model: Model, cfg: TrainCfg, steps_per_call: int,
                          static_schedule: Optional[Tuple[bool, ...]] = None):
    """K = steps_per_call train steps per call over a K-stacked batch
    (`stack_batches`), K-stacked yx [K, R, 2] and draws (each [K, B, R,
    ...]), or randomness drawn from `generator` step by step: a callable
    (state, stacked_batch, yx=None, draws=None, generator=None) -> metrics,
    each [K]; the same as K calls of `make_train_step`'s with the same
    randomness. `static_schedule`, a tuple of K proposal gates, is baked
    into one program of K substeps; without it each substep takes the
    schedule's gate and replays the one-step program of that gate."""
    if static_schedule is not None and len(static_schedule) != steps_per_call:
        raise ValueError(f"static_schedule has {len(static_schedule)} gates, "
                         f"steps_per_call is {steps_per_call}")

    def step(state: TrainState, batch: RawBatch, yx=None, draws=None,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        if state.model is not model or state.cfg != cfg:
            raise ValueError("make_multi_train_step: the state is not of this model and "
                             "config")
        k = steps_per_call
        at = [RawBatch(**{n: None if getattr(batch, n) is None else getattr(batch, n)[i]
                          for n in _BATCH_FIELDS}) for i in range(k)]
        drawn = [step_randomness(state, at[i], generator,
                                 None if yx is None else yx[i],
                                 None if draws is None else [d[i] for d in draws])
                 for i in range(k)]
        if static_schedule is None:
            out = []
            for i in range(k):
                updated, _ = step_gate(state)
                out.append(_run_program(state, (updated,), False, at[i], *drawn[i]))
            return {n: torch.stack([m[n] for m in out]) for n in out[0]}
        yx = None if drawn[0][0] is None else torch.stack([d[0] for d in drawn])
        draws = [torch.stack(ds) for ds in zip(*(d[1] for d in drawn))]
        return _run_program(state, tuple(bool(g) for g in static_schedule), True, batch,
                            yx, draws)

    return step


class MultiStepDispatch:
    """Pick the program for each steps_per_call > 1 window (the JAX
    package's host logic, copied). The steady-state proposal-gate cycle
    (update_every frozen steps + 1 update) settles into a fixed rotation
    whose phase depends on where the warmup schedule left the update
    counter, so once a window is past `warmup` (at least 10 steps: the
    schedule forces updates before step 10), a statically gated program is
    built for each gate tuple on its second sight, at most `max_programs`;
    other windows get `default`."""

    def __init__(self, build_fn, warmup: int = 0, max_programs: int = 4):
        self._build = build_fn  # gate tuple -> program
        self._programs = {}
        self._seen = {}
        self._cap_logged = set()
        self.warmup = max(warmup, 10)
        self.max_programs = max_programs

    def __len__(self) -> int:
        """The gate-tuple programs built so far."""
        return len(self._programs)

    def select(self, step, gates, default):
        """step: the window's first step; gates: its host_step_schedule
        values. Returns the statically gated program of a recurring
        post-warmup tuple, else `default`."""
        if step < self.warmup:
            return default
        gt = tuple(bool(g) for g in gates)
        fn = self._programs.get(gt)
        if fn is not None:
            return fn
        n = self._seen.get(gt, 0) + 1
        self._seen[gt] = n
        if n >= 2:
            if len(self._programs) < self.max_programs:
                fn = self._build(gt)
                self._programs[gt] = fn
                return fn
            if gt not in self._cap_logged:
                self._cap_logged.add(gt)
                print(f"MultiStepDispatch: max_programs={self.max_programs} reached; "
                      f"recurring gate tuple {gt} stays on the default program", flush=True)
        return default


def stack_batches(batches: Sequence[RawBatch]) -> RawBatch:
    """Stack K RawBatches of tensors along a new leading axis (None stays
    None), for make_multi_train_step."""
    return RawBatch(**{n: None if getattr(batches[0], n) is None else
                       torch.stack([getattr(b, n) for b in batches])
                       for n in _BATCH_FIELDS})
