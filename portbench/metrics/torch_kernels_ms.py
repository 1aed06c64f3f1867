"""torch_kernels_ms.train, .action and .control (the suffix names the
end-to-end metric it moves): device ms a step (a request, in .control) of
the traced sub-window in kernels that are not the port's own (PyTorch's
reductions, elementwise and copy kernels, cuBLAS, cuDNN)."""

from portbench.harness import readers


def read(cell, out):
    return readers.torch_kernels_ms(out)
