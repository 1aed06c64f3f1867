"""capture_s.setup: seconds of set-up in the programs' captures (the
`njf.program.capture` spans: two warm-up calls, the capture, a
synchronize; harness/spans.py)."""

from portbench.harness import spans


def read(cell, out):
    return spans.capture_s()
