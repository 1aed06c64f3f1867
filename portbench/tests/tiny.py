"""A cell cut to a size the CPU runs in seconds: the same configuration,
traffic and limits, with a smaller image, fewer rays and samples."""

import copy
import time

from portbench.harness import cells, context


def tiny_cell(workload: str, dtype: str = "float32"):
    cell = copy.deepcopy(cells.resolve(workload))
    cfg, tr = cell.config, cell.traffic
    cfg["dtype"] = dtype
    cfg["image_hw"] = [64, 96]
    r = cfg["model"]["rendering"]
    r["num_proposal_samples"], r["num_nerf_samples"], r["epipolar_knots"] = [16], 16, [8, 4, 2]
    tr["batch"] = 2
    if tr["kind"] == "train_program":
        tr.update(rays=8, pool=3, traced_calls=1)
    else:
        tr.update(rays=32, frames=3, sample_from=3, sampled=2, solve_iters=10)
    return cell


def cpu_context(cell, seed: int, seconds: float = 0.0):
    import torch

    return context.RunContext(cell=cell, seed=seed, seconds=seconds, trace=False,
                              device=torch.device("cpu"), t0=time.perf_counter(),
                              profile=None)
