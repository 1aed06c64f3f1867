"""conv_roofline_pct.train: the least time of a step's 24 stride-1 3x3
convs (forward, input gradient and weight gradient; harness.work.
conv_s1_bound_s) over the device time a step of the kernels that run them
(K9-fwd / K10, K9-dgrad, K9-wgrad and their ordered sums)."""

from portbench.harness import readers, work

PATTERNS = (r"conv3x3_(tma|legacy)_kernel", r"wgrad_(tma|legacy)_kernel", r"stats_sum_kernel",
            r"sum_splits_kernel")


def read(cell, out):
    h, w = cell.config["image_hw"]
    return readers.share_of_bound(out, work.conv_s1_bound_s(h, w, cell.traffic["batch"]),
                                  PATTERNS)
