#!/usr/bin/env python3
"""The port's benchmark: one cell of BENCHMARK.json, once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA card. The cell's
configuration (portbench/configs/), traffic mix (portbench/traffic/), the
module of the mix's kind (portbench/kinds/), its limits (portbench/limits/)
and the readers of its per-layer metrics (portbench/metrics/) are found by
the names BENCHMARK.json gives. With --trace 0 the result holds the cell's
end-to-end metrics; with --trace 1 its per-layer metrics, read from a short
steady sub-window under torch.profiler after the measured window. Every run
checks what the timed path produced against the plain reference
(portbench/reference/) once the window has closed. The last line of
standard output is the result (one JSON object); every line before it
starts with the card's name, device count and power limit. Exits non-zero,
with no result, without a card, or if JAX, Flax or the JAX package was
loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _environment() -> None:
    """Every cache of the program inside the checkout, at fixed paths (the
    port builds its kernel library into build/torch_kernels/ itself)."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(REPO / "build" / "triton_cache"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(REPO / "build" / "torch_extensions"))
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))


def per_layer(cell, out) -> dict:
    """Each per-layer metric of the cell that its reader finds something to
    read for."""
    from portbench.harness import cells

    metrics = {}
    for m in cell.per_layer:
        value = cells.reader(m["name"]).read(cell, out)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return metrics


def judge(cell, out) -> tuple:
    """(correct, [(name, value, limit)]): every number the cell's limits
    file names, within its limit (a number missing or not finite fails)."""
    rows = [(name, float(out.checks.get(name, float("nan"))), lim)
            for name, lim in sorted(cell.limits.items())]
    correct = bool(rows) and out.attempted > 0 and all(v == v and v <= lim for _, v, lim in rows)
    return correct, rows


def main(argv=None) -> int:
    args = _args(argv)
    _environment()
    from portbench.harness import cells, context, trace as tracing

    cell = cells.resolve(args.workload)
    chips = next(w["chips"] for w in cells.load_json(REPO / "BENCHMARK.json")["workloads"]
                 if w["name"] == args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    card = context.card_line(chips)

    def log(msg: str, err: bool = False) -> None:
        print(f"[{card}] {msg}", file=sys.stderr if err else sys.stdout, flush=True)

    ctx = context.RunContext(cell=cell, seed=args.seed, seconds=args.seconds,
                             trace=bool(args.trace), device=torch.device("cuda", 0), t0=T0,
                             profile=tracing.profile)
    log(f"workload {cell.name} seed {args.seed} seconds {args.seconds} trace {args.trace}")
    out = cells.kind_module(cell.kind).run(ctx)
    found = context.loaded_forbidden()
    if found:
        log(f"forbidden modules loaded in this process: {found}", err=True)
        return 3
    if args.trace:
        metrics = per_layer(cell, out)
    else:
        metrics = {m["name"]: {"value": float(out.setup_s if m["name"] == "setup_s"
                                              else out.e2e[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    correct, rows = judge(cell, out)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device}
    if args.trace:
        device.update(busy_s=out.trace.busy_s, window_s=out.trace.wall_s)
        result["breakdown"] = out.trace.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    log(f"setup_s {out.setup_s} attempted {out.attempted} context "
        + json.dumps({k: v for k, v in out.context.items() if isinstance(v, (int, float))}))
    log("readings " + json.dumps(out.checks))
    for name, v, lim in rows:
        log(f"check {name} {v!r} limit {lim!r}", err=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
