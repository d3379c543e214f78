"""stream: `jit_step` back to back on one lineage, on one card, nothing
read back.

A CUDA event is recorded on the stream after each call; the host waits on
the event `LAG` calls back, so it runs at most that far ahead and the run
ends near `--seconds`.  Set-up captures both of the lineage's graphs (one
from each buffer set) and replays each twice; the first call's result is
kept on the host for the check of the start.  The window's samples: the
start, the window's last step, and one more call after the window from a
copy of its input (the graph from the other buffer set).
"""

from __future__ import annotations

import time

from fluid_bench import stats
from fluid_bench.loop import (LAG, SETUP_CALLS, TRACE_CALLS, WARM_CALLS,
                              Clock, Window, _clone, _context, _host, _peak,
                              _sync, as_state, program_config)
from fluid_bench.state import initial
from fluid_bench.trace import Stretch, span


def run(traffic, fields, seed, seconds, trace, device, t0,
        ranks=None) -> Window:
    from tpu_fluid_torch.solver import graph
    setup = [("import program", time.perf_counter())]
    cfg = program_config(fields)

    def call(s):
        return graph.jit_step(s, cfg)

    # set-up: the graph from set A (its result kept for the start check),
    # the graph from set B, then two replays of each
    _context(device)
    setup.append(("device context", time.perf_counter()))
    s = as_state(initial(fields, seed, device))
    _sync(device)
    setup.append(("seeded state", time.perf_counter()))
    s = call(s)
    _sync(device)
    setup.append(("first call", time.perf_counter()))
    start = _host(s)
    setup.append(("start sample", time.perf_counter()))
    for _ in range(SETUP_CALLS - 1):
        s = call(s)
    _sync(device)
    setup.append(("warm calls", time.perf_counter()))
    clock = Clock(device)
    stretch = Stretch(device, WARM_CALLS, TRACE_CALLS) if trace else None
    if stretch is not None:
        stretch.start()
    window_start = time.perf_counter()
    setup_s = window_start - t0
    marks = [clock.mark()]
    prev = None
    calls = 0
    while True:
        traced = stretch is not None and stretch.on()
        with span("jit_step", traced):
            prev, s = s, call(s)
        marks.append(clock.mark())
        calls += 1
        if len(marks) > LAG:
            with span("wait", traced):
                clock.wait(marks[-1 - LAG])
        if stretch is not None:
            stretch.advance(calls)
        paused = stretch.paused if stretch is not None else 0.0
        if time.perf_counter() - window_start - paused >= seconds:
            break
    peak = _peak(device)
    _sync(device)
    times = [clock.seconds(a, b) for a, b in zip(marks, marks[1:])]
    window = clock.seconds(marks[0], marks[-1])
    summary = stretch.read() if stretch is not None else None
    # after the window: the last step is checked, and one more call, from
    # a copy of its input (the call overwrites the last step's input), for
    # the graph from the other set
    kept = _clone(prev)
    last = call(s)
    _sync(device)
    made = SETUP_CALLS + calls
    samples = [{"input": None, "seed": seed, "output": start, "steps": 1},
               {"input": kept, "output": s._asdict(), "steps": made},
               {"input": s._asdict(), "output": last._asdict(),
                "steps": made + 1}]
    return Window(
        end_to_end={"steps_per_s": stats.rate(calls, window),
                    "step_ms_p95": stats.percentile(times, 95) * 1e3},
        count=calls, samples=samples, memory_peak_bytes=peak, spans={},
        trace=summary, setup_s=setup_s, times=times, setup=setup)
