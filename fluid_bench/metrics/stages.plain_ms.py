"""Device ms a step of every kernel in the traced stretch that is not
from the program's CUDA library: PyTorch's own kernels, which run the
plain passes of the step."""


def read(run):
    if not run.window.trace:
        return None
    return run.window.trace.kernel_ms_per_step(
        lambda name: not run.library(name))
