"""device_idle_pct.train, .action and .control (the suffix names the
end-to-end metric it moves): the share of the traced sub-window's wall
time (its first host event to its last device event) in which no
operation ran on the device (the union of the device intervals)."""

from portbench.harness import readers


def read(cell, out):
    return readers.device_idle_pct(out)
