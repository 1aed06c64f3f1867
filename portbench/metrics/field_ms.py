"""field_ms.train, .action and .control (the suffix names the end-to-end metric
it moves): device ms a step (a request, in .control) in every field trunk
call (K7, wherever it nests: the proposal density, the density and Jacobian
heads), the self time of its marks (harness/spans.py: the last replay of the
cell's programs)."""

from portbench.harness import spans

LAYERS = ("field",)


def read(cell, out):
    return spans.layers_ms(cell, LAYERS)
