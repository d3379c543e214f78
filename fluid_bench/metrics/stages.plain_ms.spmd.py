"""Device ms a step of every kernel in the traced stretch that is neither
from the program's CUDA library nor NCCL's: PyTorch's own kernels, which
run the plain passes of the x-slab step.  This is `stages.plain_ms` for a
multi-card cell, whose NCCL kernels are no plain pass (`exchange.nccl_ms`
reads them).  The ranks' values merge to their maximum: the rank with the
most plain work."""


def read(run):
    if not run.window.trace:
        return None
    return run.window.trace.kernel_ms_per_step(
        lambda name: not run.library(name) and "nccl" not in name.lower())


def merge(values):
    return max(values)
