"""Faults planted in the program under test, to show that the check sees
them (the CPU tests and calibrate.py; the benchmark's own runs plant
none). Each is a context manager that patches the port in place."""

import contextlib
import dataclasses


def _half(x):
    """Every tensor of x cut to the first half of its leading (batch) axis."""
    import torch

    if isinstance(x, torch.Tensor):
        return x[: max(1, x.shape[0] // 2)] if x.dim() else x
    if isinstance(x, (tuple, list)):
        return type(x)(_half(v) for v in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _half(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return x


@contextlib.contextmanager
def half_batch():
    """The loss of a train step over the first half of the batch's rows
    alone (its mean taken over those)."""
    from neural_jacobian_field_torch.training import train as T

    saved = T.perception_loss, T.action_loss
    T.perception_loss = lambda out, target, cfg: saved[0](_half(out), _half(target), cfg)
    T.action_loss = lambda out, target, cfg: saved[1](_half(out), _half(target), cfg)
    try:
        yield
    finally:
        T.perception_loss, T.action_loss = saved


@contextlib.contextmanager
def state_unchanged():
    """Adam's step leaves the parameters and moments as they were (its count
    still advances)."""
    from neural_jacobian_field_torch.training import optim

    saved = optim.Adam.step

    def step(self, closure=None):
        self.prepare().add_(1)

    optim.Adam.step = step
    try:
        yield
    finally:
        optim.Adam.step = saved


@contextlib.contextmanager
def inputs_stale():
    """Every call of the train program reads the batch and draws of its
    first call, as input buffers that are never refreshed would."""
    from neural_jacobian_field_torch import training

    saved = training.make_multi_train_step

    def make(*args, **kw):
        step, first = saved(*args, **kw), []

        def stale(state, batch, yx=None, draws=None):
            if not first:
                first.append((batch, yx, draws))
            batch, yx, draws = first[0]
            return step(state, batch, yx=yx, draws=draws)

        return stale

    training.make_multi_train_step = make
    try:
        yield
    finally:
        training.make_multi_train_step = saved


@contextlib.contextmanager
def answer_altered():
    """The inverse-dynamics solve returns its best action with the first
    component's sign flipped."""
    import torch

    from neural_jacobian_field_torch.inference import action_opt

    saved = action_opt._adam_solve

    def solve(*args, **kw):
        best, *rest = saved(*args, **kw)
        flip = torch.ones_like(best)
        flip[..., :1].mul_(-1.0)
        return (best * flip, *rest)

    action_opt._adam_solve = solve
    try:
        yield
    finally:
        action_opt._adam_solve = saved


@contextlib.contextmanager
def density_scaled():
    """The served encoding's density head returns its density times e (the
    activation's offset of -1 left out); the compositing weights follow it."""
    import math

    from neural_jacobian_field_torch.models import decoders

    saved = decoders.ActionDecoderBase.encode_image

    def encode_image(self, *args, **kw):
        density, jacobian = saved(self, *args, **kw)
        return density * math.e, jacobian

    decoders.ActionDecoderBase.encode_image = encode_image
    try:
        yield
    finally:
        decoders.ActionDecoderBase.encode_image = saved


FAULTS = {"half_batch": half_batch, "state_unchanged": state_unchanged,
          "answer_altered": answer_altered, "density_scaled": density_scaled,
          "inputs_stale": inputs_stale}
