"""Traffic kind "train_program_exact": the captured K-step train program of
kinds/train_program.py (its set-up, window, traced sub-window, release and
readings, by import) on a configuration whose samples read their own
features from every pyramid level (`pixel_feature_mode: "exact"`). What
differs is what the program is held to and counted by: the check runs the
exact path's plain reference (reference/exact.py), whatever the
configuration's mode, so a program built with another feature path fails
it; the window's operations are harness/work_exact.py's. The kind's
programs and entry spans are the train program's (harness/spans.py)."""

import time
from typing import Dict, Optional

from portbench.harness import spans, stats, work_exact
from portbench.harness.context import Outcome
from portbench.harness.program import memory_peak_bytes
from portbench.kinds import train_program as base
from portbench.reference.exact import train_step
from portbench.reference.model import Precision
from portbench.reference.steps import Field, new_optimizer

KIND = "train_program_exact"
spans.PROGRAMS.setdefault(KIND, spans.PROGRAMS["train_program"])
spans.ENTRIES.setdefault(KIND, spans.ENTRIES["train_program"])

setup, window, release, readings = base.setup, base.window, base.release, base.readings


def reference_call(cell, entry, start, device, precision: str = "exact",
                   steps: Optional[int] = None):
    """The exact reference's K steps (or the first `steps`) on `entry` from
    `start`, as base.reference_call takes them: (losses, params, first
    moments)."""
    import torch

    tr = cell.traffic
    params = {k: v.to(device).clone() for k, v in start["params"].items()}
    field = Field(cell.config["model"], params, Precision(precision))
    opt = new_optimizer(field, tr["mode"], tr["lr"], tr["warm_up_steps"], start["count"])
    for n, v in base.second_moments(tr, opt.names).items():
        opt.v[n].fill_(v)
    for key, moments in (("m", opt.m), ("v", opt.v)):
        for n, t in (start.get(key) or {}).items():
            moments[n].copy_(t)
    losses = []
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for i, gate in enumerate(base.gates(tr)[:steps]):
            losses.append(train_step(field, opt, base._step_inputs(entry, i), gate, tr["mode"],
                                     tr["loss"]))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return {"loss": losses, "params": {k: v.cpu() for k, v in params.items()},
            "m": {k: v.cpu() for k, v in opt.m.items()}}


def check(cell, checked, device, precision: str = "exact") -> Dict[str, float]:
    """base.check against the exact reference: "first.<number>",
    "last.<number>", and the worse of the two under the plain name."""
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
    """The cell once, as base.run: set-up, the window, the traced
    sub-window, the last checked call, the memory peak, the check."""
    cell, tr = ctx.cell, ctx.cell.traffic
    session = setup(ctx)
    setup_s = time.perf_counter() - ctx.t0
    calls, elapsed = window(session, ctx.seconds)
    k = tr["steps_per_call"]
    h, w = cell.config["image_hw"]
    out = Outcome(setup_s=setup_s, attempted=calls, failed=0)
    out.e2e["train_rays_per_sec"] = stats.window_rate(calls * k * tr["batch"] * tr["rays"],
                                                      elapsed)
    out.context.update(window_s=elapsed, calls=calls, steps=calls * k,
                       call_flops=work_exact.call_flops(cell.config["model"], h, w, tr["batch"],
                                                        tr["rays"], tr["mode"], base.gates(tr)))
    if ctx.trace:
        n = tr["traced_calls"]
        out.trace = ctx.profile(lambda: [session.call() for _ in range(n)], units=n * k)
    session.last_call()
    out.memory_peak_bytes = memory_peak_bytes(ctx.device)
    out.checks = check(cell, release(session), ctx.device)
    return out
