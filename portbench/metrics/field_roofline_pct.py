"""field_roofline_pct.train and .action (the suffix names the end-to-end
metric it moves): the least time of a step's trunk work as the
fused trunk kernels take it (the projected latent and the encoded
coordinates in, the output out; forward and backward, averaged over the
gate schedule; harness.work.field_bound_s) over the device time a step of
the K7 kernels (forward, the backward's gradient chain, weight-gradient
pass and ordered sums)."""

from portbench.harness import readers, work

PATTERNS = (r"field_mlp_(wg|fwd|bwd_chain|bwd|dw|dwz)_kernel",
            r"reduce_(bwd|partials|splits)_kernel")


def read(cell, out):
    tr = cell.traffic
    gates = [bool(g) for g in tr["gates"]]
    bound = sum(work.field_bound_s(cell.config["model"], tr["batch"], tr["rays"], tr["mode"], g)
                for g in gates) / len(gates)
    return readers.share_of_bound(out, bound, PATTERNS)
