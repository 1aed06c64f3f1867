"""encoder_ms.train, .action and .control (the suffix names the end-to-end
metric it moves): device ms a step (a request, in .control) in the encoder
(the ResNet pyramid, its BatchNorm and upsampling; forward and backward),
the self time of its marks (harness/spans.py: the last replay of the cell's
programs)."""

from portbench.harness import spans

LAYERS = ("encoder",)


def read(cell, out):
    return spans.layers_ms(cell, LAYERS)
