"""Traffic kind "train_program": the port's captured K-step train program
(`make_multi_train_step` with a static proposal-gate schedule) driven back
to back on a pool of seeded stacked batches, as a training run's steady
state drives it.

Set-up: the model with the benchmark's weights, the train state at the
mix's starting step (Adam's count and the proposal counter there, its
first moments zero, its second moments as the mix states them), a pool of
stacked batches and their randomness made on the device, and the first
call (two warm-ups and the capture, then the call) on the pool's first
entry, whose effect is kept on the host for the check; a second call lets
the first replay's one-time work happen in set-up. The window: calls on
the next entries, two in flight at most (a loop that reads each call's
metrics one call late). After the window (and the traced sub-window) the
program's whole state is taken to the host and one more call made, on an
entry other than the first and other than the window's last, whose
effect is kept too. The check: once the program is freed, the reference
takes the same K steps of each of the two calls, from the seeded start
for the first and from the program's own state for the last (weights,
BatchNorm statistics, Adam's moments and count), on the same batches and
draws; each call's losses, its share of Adam's first moments, the
parameters' change and the BatchNorm statistics' change are compared leaf
by leaf, and in stage 2 the frozen parameters must not have moved at
all."""

import dataclasses
import math
import statistics
import time
from typing import Dict, List, Optional

from portbench.harness import stats, work
from portbench.harness.context import Outcome
from portbench.harness.inputs import cameras
from portbench.harness.program import build_model, memory_peak_bytes, sub_seed, synchronize
from portbench.harness.weights import make_weights, serving, training
from portbench.reference.model import Precision, is_buffer, parameter_spec, trainable
from portbench.reference.steps import Field, StepInputs, new_optimizer, train_step

_BATCH_FIELDS = ("ctxt_rgb", "ctxt_extrinsics", "ctxt_intrinsics", "robot_action", "trgt_rgb",
                 "trgt_depth", "trgt_extrinsics", "trgt_intrinsics", "near", "far", "flow",
                 "pixel_selector", "pixel_motion", "pixel_visible_mask")


def make_entry(traffic: dict, config: dict, g, device) -> Dict[str, object]:
    """One call's inputs: K stacked batches [K, B, ...] (whole images, as a
    loader ships them), the pixel set of each step [K, R, 2] (none with
    tracks) and each sampling level's stratified jitter [K, B, R, S + 1]."""
    import torch

    k, b = traffic["steps_per_call"], traffic["batch"]
    h, w = config["image_hw"]
    rays = traffic["rays"]
    lo, hi = traffic["depth_range"]
    ctx, trgt, intr = cameras(traffic, device)
    e = {
        "ctxt_rgb": torch.rand((k, b, h, w, 3), generator=g, device=device),
        "ctxt_extrinsics": ctx.expand(k, b, 4, 4).contiguous(),
        "ctxt_intrinsics": intr.expand(k, b, 3, 3).contiguous(),
        "robot_action": traffic["action_std"] * torch.randn((k, b, config["model"]["action_dim"]),
                                                            generator=g, device=device),
        "trgt_rgb": torch.rand((k, b, h, w, 3), generator=g, device=device),
        "trgt_depth": lo + (hi - lo) * torch.rand((k, b, h, w, 1), generator=g, device=device),
        "trgt_extrinsics": trgt.expand(k, b, 4, 4).contiguous(),
        "trgt_intrinsics": intr.expand(k, b, 3, 3).contiguous(),
        "near": torch.full((k, b), traffic["near"], device=device),
        "far": torch.full((k, b), traffic["far"], device=device),
    }
    sup = traffic.get("supervision")
    if sup == "flow":
        e["flow"] = traffic["motion_std"] * torch.randn((k, b, h, w, 2), generator=g,
                                                        device=device)
    elif sup == "tracks":
        e["pixel_selector"] = torch.randint(0, h * w, (k, b, rays), generator=g, device=device)
        e["pixel_motion"] = traffic["motion_std"] * torch.randn((k, b, rays, 2), generator=g,
                                                                device=device)
        e["pixel_visible_mask"] = (torch.rand((k, b, rays), generator=g, device=device)
                                   < traffic["visible_share"]).float()
    if sup != "tracks":
        u = torch.rand((k, rays, 2), generator=g, device=device)
        e["yx"] = (u * torch.tensor([float(h), float(w)], device=device)).long()
    rc = config["model"]["rendering"]
    e["draws"] = [torch.rand((k, b, rays, s + 1), generator=g, device=device)
                  for s in (*rc["num_proposal_samples"], rc["num_nerf_samples"])]
    if "row_scale_range" in traffic:  # rows of differing motion: a command and its motion
        lo, hi = (math.log(v) for v in traffic["row_scale_range"])  # scaled together
        scale = torch.exp(lo + (hi - lo) * torch.rand((k, b), generator=g, device=device))
        e["robot_action"] = e["robot_action"] * scale[..., None]
        for n in ("flow", "pixel_motion"):
            if n in e:
                e[n] = e[n] * scale.reshape(k, b, *([1] * (e[n].dim() - 2)))
    return e


def _raw_batch(entry):
    from neural_jacobian_field_torch.training import RawBatch

    return RawBatch(**{n: entry.get(n) for n in _BATCH_FIELDS})


def _step_inputs(entry, i) -> StepInputs:
    kw = {n: (None if entry.get(n) is None else entry[n][i]) for n in _BATCH_FIELDS}
    return StepInputs(**kw, draws=[d[i] for d in entry["draws"]],
                      yx=None if entry.get("yx") is None else entry["yx"][i])


def weights_for(cell, seed: int, device):
    spec = parameter_spec(cell.config["model"])
    style = serving if cell.traffic.get("weights") == "serving" else training
    return make_weights(style(spec), sub_seed(seed, "weights"), device)


@dataclasses.dataclass
class Session:
    model: object
    state: object
    step: object
    pool: List[dict]
    checked: List[tuple] = dataclasses.field(default_factory=list)  # (entry, start, after)
    calls: int = 0

    def call(self, index: Optional[int] = None):
        """One call on the pool's next entry (or on entry `index`)."""
        e = self.pool[self.calls % len(self.pool) if index is None else index]
        self.calls += 1
        return self.step(self.state, _raw_batch(e), yx=e.get("yx"), draws=e["draws"])

    def checked_call(self, index: int, start: dict):
        """A call on entry `index` whose effect is kept for the check, with
        the state it started from (`start`, on the host)."""
        metrics = self.call(index)
        self.checked.append((self.pool[index], start, _record(self.state, metrics)))

    def last_call(self):
        """After the window: the program's state to the host, then a checked
        call on an entry other than the first and the window's last."""
        opt = self.state.optimizer
        start = _record(self.state, None)
        start["v"] = {n: opt.state[p]["exp_avg_sq"].detach().cpu().clone()
                      for n, p in self.model.named_parameters() if p in opt.state}
        start["count"] = float(opt.prepare())
        last = (self.calls - 1) % len(self.pool)
        self.checked_call(next(i for i in range(1, len(self.pool)) if i != last), start)


def second_moments(traffic: dict, names) -> Dict[str, float]:
    """Adam's second moment at the start, by leaf: the square of the
    gradient RMS the mix states for it ("adam_v0_rms": a number for every
    leaf or a table by name, the rest at "default"; zero where it states
    none). The first moments start at zero."""
    spec = traffic.get("adam_v0_rms", 0.0)
    if not isinstance(spec, dict):
        return {n: float(spec) ** 2 for n in names}
    return {n: float(spec.get(n, spec.get("default", 0.0))) ** 2 for n in names}


def gates(traffic) -> tuple:
    return tuple(bool(g) for g in traffic["gates"])


def setup(ctx) -> Session:
    import torch

    from neural_jacobian_field_torch.training import (
        TrainCfg, create_train_state, make_multi_train_step)

    cell, tr, dev = ctx.cell, ctx.cell.traffic, ctx.device
    weights = weights_for(cell, ctx.seed, dev)
    before = {k: v.detach().cpu().clone() for k, v in weights.items()}
    model = build_model(cell.config, weights, dev)
    del weights
    cfg = TrainCfg(mode=tr["mode"], lr=tr["lr"], warm_up_steps=tr["warm_up_steps"],
                   rays_per_batch=tr["rays"])
    state = create_train_state(model, cfg)
    opt = state.optimizer
    opt.prepare().fill_(float(tr["start_step"]))
    v0 = second_moments(tr, [n for n, p in model.named_parameters() if p in opt.state])
    for n, p in model.named_parameters():
        if p in opt.state:
            opt.state[p]["exp_avg_sq"].fill_(v0[n])
    state.step, state.steps_since_update = tr["start_step"], tr["steps_since_update"]
    step = make_multi_train_step(model, cfg, tr["steps_per_call"], static_schedule=gates(tr))
    g = torch.Generator(device=dev)
    g.manual_seed(sub_seed(ctx.seed, "inputs"))
    pool = [make_entry(tr, cell.config, g, dev) for _ in range(tr["pool"])]
    session = Session(model, state, step, pool)
    session.checked_call(0, {"params": before, "m": None, "v": None,
                             "count": float(tr["start_step"])})
    session.call()
    synchronize(dev)
    return session


def _record(state, metrics) -> Dict[str, object]:
    """The program's state on the host: the losses of a call (`metrics`, if
    given), parameters, BatchNorm statistics and Adam's first moments, by
    name."""
    opt = state.optimizer
    moments = {n: opt.state[p]["exp_avg"].detach().cpu().clone()
               for n, p in state.model.named_parameters() if p in opt.state}
    return {"loss": None if metrics is None else
            metrics["loss/total"].detach().float().cpu().tolist(),
            "params": {n: t.detach().cpu().clone() for n, t in state.model.state_dict().items()},
            "m": moments}


def window(session: Session, seconds: float):
    """Calls back to back for `seconds`, two in flight at most; returns
    (calls, elapsed seconds) over all of their work."""
    import torch

    cuda = session.model.parameters().__next__().device.type == "cuda"
    prev, n = None, 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        session.call()
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            if prev is not None:
                prev.synchronize()
            prev = ev
        n += 1
    if cuda:
        torch.cuda.synchronize()
    return n, time.perf_counter() - t0


def release(session: Session) -> List[tuple]:
    """Free the program and its state; return the checked calls."""
    import gc

    import torch

    checked = session.checked
    session.model.programs = None
    session.model = session.state = session.step = session.pool = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return checked


def reference_call(cell, entry, start, device, precision: str = "exact",
                   steps: Optional[int] = None):
    """The reference's K steps (or the first `steps`) on `entry` from
    `start` (parameters; Adam's first and second moments, None for the
    seeded start's zeros and stated second moments; Adam's count): (losses,
    params, first moments)."""
    import torch

    tr = cell.traffic
    params = {k: v.to(device).clone() for k, v in start["params"].items()}
    field = Field(cell.config["model"], params, Precision(precision))
    opt = new_optimizer(field, tr["mode"], tr["lr"], tr["warm_up_steps"], start["count"])
    for n, v in second_moments(tr, opt.names).items():
        opt.v[n].fill_(v)
    for key, moments in (("m", opt.m), ("v", opt.v)):
        for n, t in (start.get(key) or {}).items():
            moments[n].copy_(t)
    losses = []
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for i, gate in enumerate(gates(tr)[:steps]):
            losses.append(train_step(field, opt, _step_inputs(entry, i), gate, tr["mode"],
                                     tr["loss"]))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return {"loss": losses, "params": {k: v.cpu() for k, v in params.items()},
            "m": {k: v.cpu() for k, v in opt.m.items()}}


def _leaf_gaps(got, want, names) -> Dict[str, float]:
    """Per leaf: the gap between the two sides' norms of the leaf, over the
    larger of the reference's norm of that leaf and of the median leaf."""
    norms = {n: float(want[n].double().norm()) for n in names}
    if not norms:
        return {}
    med = statistics.median(norms.values())
    return {n: abs(float(got[n].double().norm()) - norms[n]) / max(norms[n], med, 1e-30)
            for n in names}


def readings(cell, start, got, want, leaves: Optional[dict] = None) -> Dict[str, float]:
    """The numbers compared for one call from `start`: the first step's loss
    and the worst step's; the call's share of Adam's first moments (the
    moments after it less the ones it started from, decayed over its K
    steps) and the parameters' change, worst leaf and median leaf (leaves
    whose reference moment is under a thousandth of the median leaf's, per
    element, left out); the BatchNorm statistics' change, worst buffer and
    median buffer; in stage 2 the largest move of a frozen parameter.
    `leaves`, if given, receives the worst leaf of each."""
    import torch

    model, mode = cell.config["model"], cell.traffic["mode"]
    before = start["params"]
    gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got["loss"], want["loss"])]
    names = [n for n in want["m"] if trainable(n, model, mode)]
    decay = 0.9 ** len(want["loss"])
    m0 = start.get("m") or {n: torch.zeros_like(want["m"][n]) for n in names}
    share = {side: {n: s["m"][n].double() - decay * m0[n].double() for n in names}
             for side, s in (("got", got), ("want", want))}
    rms = {n: float(share["want"][n].norm()) / math.sqrt(share["want"][n].numel())
           for n in names}
    med = statistics.median(rms.values())
    live = [n for n in names if rms[n] >= 1e-3 * med]
    delta = {side: {n: s["params"][n].double() - before[n].double() for n in before}
             for side, s in (("got", got), ("want", want))}
    buffers = [n for n in before if is_buffer(n)]
    out = {"loss_gap.step1": gaps[0], "loss_gap": max(gaps)}
    for key, per_leaf in (("grad_gap", _leaf_gaps(share["got"], share["want"], live)),
                          ("step_gap", _leaf_gaps(delta["got"], delta["want"], live)),
                          ("stats_gap", _leaf_gaps(delta["got"], delta["want"], buffers))):
        worst = max(per_leaf, key=per_leaf.get)
        out[key] = per_leaf[worst]
        out[key + ".median"] = statistics.median(per_leaf.values())
        if leaves is not None:
            leaves[key] = worst
    if mode != "perception":
        frozen = [n for n in before if not is_buffer(n) and not trainable(n, model, mode)]
        out["frozen_moved"] = max(float(delta["got"][n].abs().max()) for n in frozen)
    return out


def check(cell, checked, device, precision: str = "exact") -> Dict[str, float]:
    """Each checked call against the reference from the state it started
    from: "first.<number>" and "last.<number>", and under the plain name
    the worse of the two. At another `precision` the reference's own run
    there stands in for the program's."""
    out: Dict[str, float] = {}
    for tag, (entry, start, after) in zip(("first", "last"), checked):
        want = reference_call(cell, entry, start, device)
        got = after if precision == "exact" else reference_call(cell, entry, start, device,
                                                                 precision)
        for key, v in readings(cell, start, got, want).items():
            out[f"{tag}.{key}"] = v
            out[key] = max(out.get(key, v), v)
    return out


def run(ctx):
    """The cell once: set-up, the window, the traced sub-window (with
    tracing), the last checked call, the memory peak, the check."""
    import torch

    cell, tr = ctx.cell, ctx.cell.traffic
    session = setup(ctx)
    setup_s = time.perf_counter() - ctx.t0
    calls, elapsed = window(session, ctx.seconds)
    k = tr["steps_per_call"]
    rays_per_call = k * tr["batch"] * tr["rays"]
    h, w = cell.config["image_hw"]
    out = Outcome(setup_s=setup_s, attempted=calls, failed=0)
    rate = stats.window_rate(calls * rays_per_call, elapsed)
    out.e2e.update({"train_rays_per_sec": rate, "action_rays_per_sec": rate})
    out.context.update(window_s=elapsed, calls=calls, steps=calls * k,
                       call_flops=work.call_flops(cell.config["model"], h, w, tr["batch"],
                                                  tr["rays"], tr["mode"], gates(tr)))
    if ctx.trace:
        n = tr["traced_calls"]
        out.trace = ctx.profile(lambda: [session.call() for _ in range(n)], units=n * k)
    session.last_call()
    out.memory_peak_bytes = memory_peak_bytes(ctx.device)
    out.checks = check(cell, release(session), ctx.device)
    return out
