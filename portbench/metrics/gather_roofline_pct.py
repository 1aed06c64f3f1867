"""gather_roofline_pct.exact (the suffix names the end-to-end metric it
moves): the least time of a stage-1 step's per-sample pyramid lookups and
their scatters (bytes over the bandwidth, averaged over the gate schedule;
harness.work_exact.gather_bound_s, from the configuration: the lookups'
ids, weights and samples, the scatters' gradients read and each map's
gradient written once) over the device time a step of their kernels: the
packed rows' gather (PyTorch's gather kernel, which the step's few small
gathers of the losses and targets share), K1-fwd on the coarse level,
K1-bwd-rows (`rows_*`) and K1-bwd (the counting sort, piece sums and
merge)."""

from portbench.harness import readers, work_exact

PATTERNS = (r"_scatter_gather_elementwise_kernel", r"onehot_gather_fwd_kernel",
            r"rows_(bucket|sort|sum)_kernel", r"bucket_(count|scan|place)_kernel",
            r"segment_sum_kernel", r"merge_parts_kernel")


def read(cell, out):
    tr = cell.traffic
    h, w = cell.config["image_hw"]
    gates = [bool(g) for g in tr["gates"]]
    bound = sum(work_exact.gather_bound_s(cell.config["model"], h, w, tr["batch"], tr["rays"], g)
                for g in gates) / len(gates)
    return readers.share_of_bound(out, bound, PATTERNS)
