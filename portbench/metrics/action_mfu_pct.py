"""action_mfu_pct: the stage-2 window's model operations (the forward, plus
the backward of what a step trains, over the 5-frozen + 1-update schedule;
harness.work.step_flops) over the window's time at the bf16 peak."""

from portbench.harness import readers, work


def read(cell, out):
    return readers.mfu_pct(out, work.PEAK_BF16_FLOPS)
