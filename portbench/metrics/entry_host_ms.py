"""entry_host_ms.train, .action and .control (the suffix names the
end-to-end metric it moves): host ms a step (a request, in .control) inside
the port's entry points (`make_multi_train_step`'s call; `encode_image`
and `optimize_actions`), from their spans recorded while the profiler ran,
over the units those spans ran (harness/spans.py)."""

from portbench.harness import spans


def read(cell, out):
    return spans.entry_host_ms(cell)
