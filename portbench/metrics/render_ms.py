"""render_ms.train, .action and .control (the suffix names the end-to-end
metric it moves): device ms a step (a request, in .control) in rendering
(compositing, depth, flow; in .control the encoding's compositing weights
and the solve's predicted flow), the self time of its marks
(harness/spans.py: the last replay of the cell's programs)."""

from portbench.harness import spans

LAYERS = ("render",)


def read(cell, out):
    return spans.layers_ms(cell, LAYERS)
