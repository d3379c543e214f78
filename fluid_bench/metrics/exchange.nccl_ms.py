"""Device ms a step of the NCCL kernels in the traced stretch, read by
kernel name: the halo exchanges, the solve's, the migration's sends and
receives, and the drop count's all-reduce.  A rank's NCCL kernels also
hold the time it waits for a neighbour that is late, so the ranks' values
merge to their minimum: the rank that waits least, whose number is the
exchanges' own cost."""


def nccl(name: str) -> bool:
    return "nccl" in name.lower()


def read(run):
    if not run.window.trace:
        return None
    return run.window.trace.kernel_ms_per_step(nccl)


def merge(values):
    return min(values)
