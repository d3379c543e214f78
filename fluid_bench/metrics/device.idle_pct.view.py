"""100 x (1 - the union of the device's kernels, copies and fills over the
traced stretch of frames / the stretch)."""


def read(run):
    return run.window.trace.idle_pct() if run.window.trace else None
