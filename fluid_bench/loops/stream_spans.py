"""stream_spans: the `stream` loop, with the program's own spans and
counters read over its window under `--trace 1`.

Under `--trace 0` it is `loops/stream.py`'s `run`, called as it is.  Under
`--trace 1` it turns the program's tracing on (`utils/profiling`) before
set-up, so that the lineage's graphs are captured with their spans
(event-record nodes inside the graph) and counters; clears what set-up's
calls recorded where the window starts (where `stream` makes its
`Clock`); and takes the program's report once the window's calls are done
(the clock's first reading, after the window's last call and its sync,
before the call after the window).  The report, span name -> record as
`profiling.report()` gives it, goes into `Window.program_spans` for the
readers of program spans (`metrics/stages.levelset_ms.py`), and one line
on standard error gives each span's device ms and each counter a step.
Tracing is off again on every exit, a raised one too.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from fluid_bench.manifest import load


def _stream():
    """`loops/stream.py` as a module of its own, whose `Clock` this loop
    replaces without touching any other loader's."""
    return load(Path(__file__).with_name("stream.py"),
                "fluid_bench_loop_stream_spans_base")


def per_step(report: dict) -> dict:
    """Device ms a replay read of each span that has them, and each
    counter's count over its additions."""
    out = {}
    for name, r in report.items():
        if r["device_calls"]:
            out[name] = {"device_ms": r["device_ms"] / r["device_calls"]}
        if r["count"] and r["calls"]:
            out.setdefault(name, {})["count"] = r["count"] / r["calls"]
    return out


def run(traffic, fields, seed, seconds, trace, device, t0, ranks=None):
    stream = _stream()
    if not trace:
        return stream.run(traffic, fields, seed, seconds, trace, device, t0,
                          ranks=ranks)
    from tpu_fluid_torch.utils import profiling
    clocks = []

    class Clock(stream.Clock):
        """The stream's clock, which also bounds the program's report to
        the window: made where the window starts, it clears the registry;
        its first reading takes the report."""

        def __init__(self, device):
            super().__init__(device)
            profiling.reset()
            self.report = None
            clocks.append(self)

        def seconds(self, a, b):
            if self.report is None:
                self.report = profiling.report()
            return super().seconds(a, b)

    stream.Clock = Clock
    profiling.tracing(True)
    try:
        window = stream.run(traffic, fields, seed, seconds, trace, device,
                            t0, ranks=ranks)
    finally:
        profiling.tracing(False)
        profiling.reset()
    window.program_spans = (clocks[0].report or {}) if clocks else {}
    print("fluid_bench: program spans a step "
          + json.dumps(per_step(window.program_spans)), file=sys.stderr)
    return window
