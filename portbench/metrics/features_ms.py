"""features_ms.train, .action and .control (the suffix names the end-to-end
metric it moves): device ms a step (a request, in .control) in the features
and the sampler (K6 packing, the epipolar knots and pixel gathers, the
proposal sampling and K5 resampling, apart from the trunks), the self time
of its marks (harness/spans.py: the last replay of the cell's programs)."""

from portbench.harness import spans

LAYERS = ("features", "sampler")


def read(cell, out):
    return spans.layers_ms(cell, LAYERS)
