#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card, in one process:

    python3 portbench/calibrate.py --workload <name> --seeds <n,...>
        [--control-seeds <n,...>] [--faults half_batch,...]

For each seed the program's reading (a train cell's two checked calls, the
last after a window of --seconds; or the window's first requests; against
the reference), for each control seed
the reference computed in the step below the configuration's precision
(fp8) against the reference, and for each planted fault (harness/faults.py)
the program's reading with the fault in it, on the control seeds. One JSON
line per reading. The benchmark's own runs never run this."""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def train_checked(drv, ctx, seconds: float, fault=None):
    """The program's two checked calls (harness: kinds/train_program.py): the
    set-up's first, and the last after a window of `seconds`."""
    import contextlib

    from portbench.harness.faults import FAULTS

    with (FAULTS[fault]() if fault else contextlib.nullcontext()):
        session = drv.setup(ctx)
        drv.window(session, seconds)
        session.last_call()
    return drv.release(session)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, required=True)
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=5.0,
                   help="the window before a train cell's last checked call")
    p.add_argument("--adam-v0-from", type=int, default=None,
                   help="set the mix's starting second moments to each leaf's first-step "
                        "gradient RMS in the reference at this seed, and print them")
    args = p.parse_args()

    import torch

    from portbench.harness import cells, context
    from portbench.harness.faults import FAULTS
    from portbench.harness.trace import profile

    cell = cells.resolve(args.workload)
    drv = cells.kind_module(cell.kind)
    dev = torch.device("cuda", 0)
    faults = [f for f in args.faults.split(",") if f]
    print(json.dumps({"card": context.card_line(1), "workload": cell.name}), flush=True)
    if args.adam_v0_from is not None:
        ctx = context.RunContext(cell=cell, seed=args.adam_v0_from, seconds=0.0, trace=False,
                                 device=dev, t0=time.perf_counter(), profile=profile)
        cell.traffic["adam_v0_rms"] = 0.0
        entry, start, _ = train_checked(drv, ctx, 0.0)[0]
        one = drv.reference_call(cell, entry, start, dev, steps=1)
        wd = 1e-5
        table = {n: float(((m / 0.1) - wd * start["params"][n]).pow(2).mean().sqrt())
                 for n, m in one["m"].items()}
        cell.traffic["adam_v0_rms"] = table
        print(json.dumps({"adam_v0_rms": table}), flush=True)

    def emit(kind, seed, readings, t0):
        print(json.dumps({"kind": kind, "seed": seed, "seconds": round(time.time() - t0, 1),
                          **readings}), flush=True)

    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        ctx = context.RunContext(cell=cell, seed=seed, seconds=0.0, trace=False, device=dev,
                                 t0=time.perf_counter(), profile=profile)
        t0 = time.time()
        if cell.kind == "train_program":
            checked = train_checked(drv, ctx, args.seconds)
            if seed in args.seeds:
                emit("program", seed, {**drv.check(cell, checked, dev),
                                       "loss": [c[2]["loss"] for c in checked]}, t0)
            if seed in args.control_seeds:
                t0 = time.time()
                emit("control_fp8", seed, drv.check(cell, checked, dev, "fp8"), t0)
                for fault in faults:
                    t0 = time.time()
                    emit(f"fault_{fault}", seed,
                         drv.check(cell, train_checked(drv, ctx, args.seconds, fault), dev), t0)
        else:
            def serve(fault=None):
                import contextlib

                with (FAULTS[fault]() if fault else contextlib.nullcontext()):
                    session = drv.setup(ctx)
                    for i in range(max(session.sampled) + 1):
                        session.request(i)
                return drv.release(session)

            kept, frames, geometry = serve()
            if seed in args.seeds:
                emit("program", seed, drv.reference_readings(cell, seed, kept, frames, geometry,
                                                             dev), t0)
            if seed in args.control_seeds:
                t0 = time.time()
                emit("control_fp8", seed, drv.reference_readings(
                    cell, seed, kept, frames, geometry, dev, "fp8"), t0)
                for fault in faults:
                    t0 = time.time()
                    k2, f2, g2 = serve(fault)
                    emit(f"fault_{fault}", seed,
                         drv.reference_readings(cell, seed, k2, f2, g2, dev), t0)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
