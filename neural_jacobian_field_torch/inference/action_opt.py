"""Inverse dynamics: find the action whose predicted flow matches a target
(PyTorch counterpart of inference/action_opt.py).

The field is evaluated once (`Model.encode_image`). The flow is linear in
the action up to the projection's divide by depth, so a solve composites
the encoding along each ray once, before its iterations
(`Model.composite_flow`: the per-sample Jacobian, [B, R, S, A * 3], read
once into [B, R, A, 3], with the composited positions, both in the target
camera's homogeneous pixel frame, and their projection). Each iteration then
reads only that composite: the action's flow is a [B, R, A, 3] product
summed over A, a divide by depth and a difference
(`Model.composited_optical_flow`), forward and backward. The closed-form
alternative solves damped normal equations on the flow Jacobian at a = 0,
taken by forward mode through the same composite.

As in the JAX package, where `optimize_actions` is one jit over a
`lax.scan` and the least-squares solve one jit, each solver is one device
program on the card (inference/programs.py): the whole `num_iters`-step
solve (the flow, its gradient with respect to the action, Adam with optax's
formula written out in tensor ops, the best-loss tracking, the loss and
action histories in preallocated buffers) is captured once and replayed per
call, and nothing in it waits on the host. On the CPU the same Python runs
eagerly.

Each iteration of the Adam solve marks its phases (utils/profiling.py):
"render" (the predicted flow, and its backward), "loss" (the objective and
its backward) and "optimizer" (the update, the histories and the best
action), on one iteration in `MARK_EVERY`; the iterations between are
marked as a whole ("iterations", shared among the three in the proportion
the marked ones give them). The composite is "render" too, as its part
"composite", which that proportion leaves out.
"""

from typing import NamedTuple, Optional

import torch

from ..models.model import CameraInput, Model, ModelInferenceEncoding
from ..utils import profiling

# optax.adam's defaults
_B1, _B2, _EPS = 0.9, 0.999, 1e-8
# the Adam solve marks its phases on every MARK_EVERY-th iteration
MARK_EVERY = 10


def _bias_correction(decay: float, step: int) -> float:
    """1 - decay**step in float32, as optax computes it (from float32 decay:
    1 - 0.999 is 1.2871e-5 of itself away from the float64 value)."""
    return float(1 - torch.tensor(decay, dtype=torch.float32) ** step)


class ActionOptResult(NamedTuple):
    action: torch.Tensor  # [B, A] best action found
    loss: torch.Tensor  # [] its loss
    losses: torch.Tensor  # [num_iters] loss history
    actions: torch.Tensor  # [num_iters, B, A] action history


def _inputs(encoding: ModelInferenceEncoding, camera_input: CameraInput,
            trgt_pixel_flow: torch.Tensor, visible_mask: Optional[torch.Tensor]) -> tuple:
    """What the solvers read: the encoding (its density is not), the target
    camera, the target flow and the mask where there is one."""
    mask = () if visible_mask is None else (visible_mask,)
    return (encoding.action_features, encoding.weights, encoding.ray_samples_positions,
            camera_input.trgt_extrinsics, camera_input.trgt_intrinsics, trgt_pixel_flow, *mask)


def _predictor(model: Model, action_features, weights, positions, trgt_extrinsics,
               trgt_intrinsics):
    """action [B, A] -> predicted flow [B, R, 2] over the cached encoding,
    composited here, once."""
    encoding = ModelInferenceEncoding(density=None, action_features=action_features,
                                      weights=weights, ray_samples_positions=positions)
    cam = CameraInput(input_image=None, ctxt_extrinsics=None, ctxt_intrinsics=None,
                      trgt_extrinsics=trgt_extrinsics, trgt_intrinsics=trgt_intrinsics)
    with profiling.layer("render", exit_mark=False), \
            profiling.layer("composite", exit_mark=False), torch.no_grad():
        composite = model.composite_flow(encoding, cam)
    return lambda action: model.composited_optical_flow(composite, action)


def _adam_solve(model: Model, num_iters: int, learning_rate: float, reg_multiplier: float,
                action_features, weights, positions, trgt_extrinsics, trgt_intrinsics, target,
                *mask_and_action0) -> tuple:
    """The whole solve, as JAX's scan computes it: per step the loss and its
    gradient at the current action (recorded in the histories, and tracked
    as the best), then optax's Adam update; the final action is scored too."""
    *mask, action0 = mask_and_action0
    predict = _predictor(model, action_features, weights, positions, trgt_extrinsics,
                         trgt_intrinsics)

    def loss_fn(action, marked=True):
        with profiling.layer("render", exit_mark=False, on=marked) as lay:
            flow = lay.output(predict(action))
        with profiling.layer("loss", exit_mark=False, on=marked):
            err = (flow - target) ** 2
            if mask:
                err = err * mask[0][..., None]
                loss = err.sum() / torch.clamp(mask[0].sum(), min=1.0)
            else:
                loss = err.mean()
            return loss + reg_multiplier * (action ** 2).mean()

    action = action0.detach()
    m, v = torch.zeros_like(action), torch.zeros_like(action)
    best_action, best_loss = action, torch.full((), float("inf"), device=action.device)
    losses = action.new_empty((num_iters,))
    actions = action.new_empty((num_iters, *action.shape))
    for step in range(1, num_iters + 1):
        marked = (step - 1) % MARK_EVERY == 0
        if (step - 1) % MARK_EVERY == 1:  # the first iteration after a marked one
            profiling.mark("iterations")
        with torch.enable_grad():
            a = action.detach().requires_grad_(True)
            loss = loss_fn(a, marked)
            (grad,) = torch.autograd.grad(loss, a)
        with profiling.layer("optimizer", exit_mark=False, on=marked):
            loss = loss.detach()
            losses[step - 1] = loss
            actions[step - 1] = action
            best_action = torch.where(loss < best_loss, action, best_action)
            best_loss = torch.minimum(loss, best_loss)
            # optax.scale_by_adam, then scale(-learning_rate), then apply_updates
            m = (1 - _B1) * grad + _B1 * m
            v = (1 - _B2) * (grad * grad) + _B2 * v
            m_hat = m / _bias_correction(_B1, step)
            v_hat = v / _bias_correction(_B2, step)
            action = action + m_hat / (torch.sqrt(v_hat) + _EPS) * -learning_rate
    with torch.no_grad():
        final_loss = loss_fn(action)
    with profiling.layer("optimizer", exit_mark=False):
        best_action = torch.where(final_loss < best_loss, action, best_action)
        best_loss = torch.minimum(final_loss, best_loss)
    return best_action, best_loss, losses, actions


def optimize_actions(model: Model, encoding: ModelInferenceEncoding,
                     camera_input: CameraInput, trgt_pixel_flow: torch.Tensor,
                     action0: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     visible_mask: Optional[torch.Tensor] = None, num_iters: int = 100,
                     learning_rate: float = 0.1, reg_multiplier: float = 0.0,
                     action_init_var: float = 0.001) -> ActionOptResult:
    """Adam on the action against target per-ray flow [B, R, 2]. action0
    defaults to N(0, action_init_var^2) drawn from `generator` (outside the
    captured program). The best action is tracked on the device."""
    batch = encoding.weights.shape[0]
    action_dim = encoding.action_features.shape[-1] // 3
    if action0 is None:
        action0 = torch.randn((batch, action_dim), generator=generator,
                              device=encoding.weights.device) * action_init_var
    inputs = _inputs(encoding, camera_input, trgt_pixel_flow, visible_mask) + (action0,)
    key = (_adam_solve, model, num_iters, learning_rate, reg_multiplier, visible_mask is None)
    with profiling.span("njf.solve", call=True):
        return ActionOptResult(*model.programs.run(
            key, inputs,
            lambda *xs: _adam_solve(model, num_iters, learning_rate, reg_multiplier, *xs),
            name="solve"))


def _least_squares(model: Model, damping: float, action_features, weights, positions,
                   trgt_extrinsics, trgt_intrinsics, target, *mask) -> tuple:
    predict = _predictor(model, action_features, weights, positions, trgt_extrinsics,
                         trgt_intrinsics)
    batch = weights.shape[0]
    action_dim = action_features.shape[-1] // 3
    a0 = torch.zeros((batch, action_dim), device=weights.device)
    with profiling.layer("render", exit_mark=False):
        with torch.no_grad():
            f0 = predict(a0)
        jac = torch.func.jacfwd(predict)(a0)  # [B, R, 2, B, A]
    profiling.mark("optimizer")
    jac = torch.einsum("brcba->brca", jac)
    resid = target - f0
    if mask:
        w = mask[0][..., None]
        jac = jac * w[..., None]
        resid = resid * w
    jtj = torch.einsum("brca,brcd->bad", jac, jac)
    jtr = torch.einsum("brca,brc->ba", jac, resid)
    scale = torch.diagonal(jtj, dim1=-2, dim2=-1).sum(-1)[..., None, None] / action_dim
    eye = torch.eye(action_dim, dtype=jtj.dtype, device=jtj.device)
    jtj = jtj + (damping * scale + 1e-20) * eye
    # like jnp.linalg.solve, no check for a singular matrix (torch.linalg.solve's
    # reads a flag back on the host)
    return (torch.linalg.solve_ex(jtj, jtr[..., None], check_errors=False).result[..., 0]
            .detach(),)


def solve_actions_least_squares(model: Model, encoding: ModelInferenceEncoding,
                                camera_input: CameraInput, trgt_pixel_flow: torch.Tensor,
                                visible_mask: Optional[torch.Tensor] = None,
                                damping: float = 1e-4) -> torch.Tensor:
    """Closed-form Gauss-Newton step from a = 0: solve min_a ||J a - r||^2 by
    normal equations with RELATIVE Tikhonov damping (scaled by the mean
    diagonal of J^T J). J comes from one forward-mode Jacobian over the
    cached encoding."""
    inputs = _inputs(encoding, camera_input, trgt_pixel_flow, visible_mask)
    with profiling.span("njf.solve", call=True):
        (action,) = model.programs.run(
            (_least_squares, model, damping, visible_mask is None), inputs,
            lambda *xs: _least_squares(model, damping, *xs), name="solve_least_squares")
    return action
