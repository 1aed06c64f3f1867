"""Adam in tensor ops with optax's order (PyTorch counterpart of the optax
chain the JAX package's training/train.py:make_optimizer builds).

Per parameter group: optax.add_decayed_weights(wd) -> scale_by_adam(b1, b2,
eps) -> scale_by_learning_rate(linear_schedule(lr * lr_mult / warmup ->
lr * lr_mult over warmup steps)), then apply_updates. The step count is one
0-d float32 tensor on the parameters' device (optax's int32 count, exact to
2^24 steps): the learning rate of a step is the schedule at the count before
it, the bias corrections 1 - b^(count + 1) are float32 powers, as optax
computes them, and the count advances in place. Nothing in `step` reads a
value back to the host, and each group's update is a few `torch._foreach_*`
calls, so a train step can be captured as a CUDA graph (training/train.py)
and the same code runs on the CPU.

`state_dict()` has torch.optim.Adam's layout (per parameter "step",
"exp_avg", "exp_avg_sq"; every "step" is the one shared count).
`load_state_dict` copies into the state tensors already held, in place, so a
captured step keeps reading them; state assigned from outside (say
utils/from_jax.load_optax_adam_state) is taken over by `prepare`, which a
captured program's key reads first.
"""

from typing import List

import torch

_STATE = ("exp_avg", "exp_avg_sq")


class Adam(torch.optim.Optimizer):
    """optax's Adam: weight decay added to the gradient before the moments
    (optax's order, not AdamW's) and the warmup schedule, scaled per group
    by the group's "lr_mult". Every held parameter takes a step, so each
    must have a gradient (zeros where the loss does not reach it)."""

    def __init__(self, params, lr: float, warm_up_steps: int, weight_decay: float = 0.0,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        defaults = dict(lr=lr, lr_mult=1.0, warm_up_steps=warm_up_steps,
                        weight_decay=weight_decay, betas=tuple(betas), eps=eps)
        super().__init__(params, defaults)
        self._count = None

    def params(self) -> List[torch.Tensor]:
        return [p for group in self.param_groups for p in group["params"]]

    @torch.no_grad()
    def prepare(self) -> torch.Tensor:
        """Put every held parameter's state in the form the step reads
        (moments like the parameter, "step" the shared count) and return the
        count. State set from outside is taken over: a count found there is
        copied into the shared one, moments on another device or dtype are
        moved. Call it outside a capture: it may copy from the host."""
        params = self.params()
        if self._count is None:
            self._count = torch.zeros((), dtype=torch.float32, device=params[0].device)
        for p in params:
            step = self.state[p].get("step")
            if step is not None and step is not self._count:
                self._count.copy_(step)
                break
        for p in params:
            s = self.state[p]
            for k in _STATE:
                t = s.get(k)
                if t is None:
                    s[k] = torch.zeros_like(p, memory_format=torch.preserve_format)
                elif t.device != p.device or t.dtype != p.dtype:
                    s[k] = t.to(device=p.device, dtype=p.dtype)
            s["step"] = self._count
        return self._count

    def state_tensors(self) -> List[torch.Tensor]:
        """Every tensor the step reads and writes in place: the count, then
        each parameter's moments (after `prepare`)."""
        count = self.prepare()
        return [count] + [self.state[p][k] for p in self.params() for k in _STATE]

    def hyperparameters(self) -> tuple:
        """The groups' settings, which a captured step bakes in."""
        return tuple(tuple(sorted((k, v) for k, v in g.items() if k != "params"))
                     for g in self.param_groups)

    def learning_rate(self, group: dict, count: torch.Tensor) -> torch.Tensor:
        """optax.linear_schedule(lr * lr_mult / warmup -> lr * lr_mult) at
        the count, in float32."""
        end = group["lr"] * group["lr_mult"]
        init, steps = end / group["warm_up_steps"], group["warm_up_steps"]
        frac = 1 - torch.clamp(count, 0, steps) / steps
        return (init - end) * frac + end

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        count = self.prepare()
        for group in self.param_groups:
            params = group["params"]
            if not params:
                continue
            # the bias corrections in float32, as optax's under float32;
            # float64 parameters take them in float64, as optax's under
            # jax_enable_x64 (its schedule stays float32 there too)
            at = count.to(torch.float64) if params[0].dtype == torch.float64 else count
            inc = at + 1
            grads = [p.grad for p in params]
            if any(g is None for g in grads):
                raise ValueError("every parameter Adam holds needs a gradient (zeros where "
                                 "the loss does not reach it)")
            b1, b2 = group["betas"]
            mu = [self.state[p]["exp_avg"] for p in params]
            nu = [self.state[p]["exp_avg_sq"] for p in params]
            # add_decayed_weights: u = g + wd * p
            u = torch._foreach_mul(params, group["weight_decay"])
            torch._foreach_add_(u, grads)
            # scale_by_adam: mu = (1 - b1) u + b1 mu, nu = (1 - b2) u^2 + b2 nu,
            # u = mu_hat / (sqrt(nu_hat) + eps)
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(u, 1 - b1))
            torch._foreach_mul_(u, u)
            torch._foreach_mul_(u, 1 - b2)
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, u)
            denom = torch._foreach_div(nu, 1 - b2 ** inc)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            u = torch._foreach_div(mu, 1 - b1 ** inc)
            torch._foreach_div_(u, denom)
            # scale_by_learning_rate, then apply_updates
            torch._foreach_mul_(u, -1 * self.learning_rate(group, count))
            torch._foreach_add_(params, u)
        count.add_(1)

    @torch.no_grad()
    def load_state_dict(self, state_dict: dict) -> None:
        """torch.optim's load, then the loaded values copied into the state
        tensors held before it, which stay (zeros and a count of 0 where the
        saved state has none)."""
        count = self.prepare()
        held = {p: dict(self.state[p]) for p in self.params()}
        super().load_state_dict(state_dict)
        count.zero_()
        for p, old in held.items():
            new = self.state[p]
            for k in _STATE:
                if k in new:
                    old[k].copy_(new[k])
                else:
                    old[k].zero_()
            if "step" in new:
                count.copy_(new["step"])
            self.state[p] = old
