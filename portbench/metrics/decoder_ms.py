"""decoder_ms.train, .action and .control (the suffix names the end-to-end
metric it moves): device ms a step (a request, in .control) in the decoders'
own work apart from the trunks (heads, colour, the Jacobian transformer),
the self time of its marks (harness/spans.py: the last replay of the cell's
programs)."""

from portbench.harness import spans

LAYERS = ("decoder",)


def read(cell, out):
    return spans.layers_ms(cell, LAYERS)
