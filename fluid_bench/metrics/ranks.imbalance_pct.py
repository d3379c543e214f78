"""How unevenly the cards share a step's work: 100 x (max - min) / max over
the ranks of each rank's device ms a step outside NCCL (its kernels other
than NCCL's, its copies and fills) in the traced stretch.  A rank reads
its own ms a step; `merge` folds the ranks' values, in rank order, into
the share.  At the start of the fountain the cards at the ends hold no
particle."""


def read(run):
    trace = run.window.trace
    if not trace or trace.steps <= 0:
        return None
    ops = [b - a for a, b, name, _ in trace.device
           if trace.start <= a < trace.end and "nccl" not in name.lower()]
    return sum(ops) * 1e-3 / trace.steps if ops else None


def merge(values):
    top = max(values)
    return 100.0 * (top - min(values)) / top if top > 0 else 0.0
