"""field_roofline_pct.exact: the least time of a stage-1 step's trunk work
in projection mode, as K7-fwd and K7-bwd take it (each point's 512-channel
latent and encoded coordinates in, the output out, the latent's gradient
out of the backward; averaged over the gate schedule; harness.work_exact.
field_bound_s, from the configuration) over the device time a step of the
K7 kernels (forward, the backward's gradient chain, weight-gradient pass
and ordered sums)."""

from portbench.harness import readers, work_exact

PATTERNS = (r"field_mlp_(wg|fwd|bwd_chain|bwd|dw|dwz)_kernel",
            r"reduce_(bwd|partials|splits)_kernel")


def read(cell, out):
    tr = cell.traffic
    gates = [bool(g) for g in tr["gates"]]
    bound = sum(work_exact.field_bound_s(cell.config["model"], tr["batch"], tr["rays"], g)
                for g in gates) / len(gates)
    return readers.share_of_bound(out, bound, PATTERNS)
