"""The one traffic generator: it reads a traffic mix's parameters and
drives the program through one run, set-up and window.

The mix's `loop` names the module `fluid_bench/loops/<loop>.py` that
drives it, found by name as the metric readers and kernel families are
(`manifest.loop_module`); its `run(traffic, fields, seed, seconds, trace,
device, t0, ranks=None)` returns a `Window`.  The loops:

  stream        `jit_step` back to back on one lineage, one card, nothing
                read back (`loops/stream.py`)
  view          the reference's frame loop, closed, one viewer, one card
                (`loops/view.py`)
  spmd_stream   `jit_spmd_step` back to back on every rank of a cell with
                several cards, a fixed number of calls (`loops/spmd_stream.py`)

A new loop is a new file there and a mix naming it: nothing here changes.
A loop that runs one rank a card sets `MULTI_CARD = True`, is handed its
`ranks.Ranks` (rank, size, rendezvous, backend) on `cuda:<rank>`, returns
the mesh it made in `Window.mesh` and its window's length in
`Window.seconds`, and defines `end_to_end(count, seconds, times)`, which
`run.py` applies to the ranks' merged window.  This module keeps what the
loops share: `Window`, `Clock`, the conversions, the syncs and the
constants below.

Each loop's set-up warms every shape its window uses and keeps the first
call's result on the host for the check of the start.  Each sample carries
the number of steps the run made up to it, which the state's step counter
has to equal.  In a traced run (`--trace 1`) the profiler is on for the
window's first `WARM_CALLS` + `TRACE_CALLS` calls (or frames:
`TRACE_FRAMES`), and the stretch read is the last `TRACE_CALLS` of them;
the time spent starting and stopping it is not counted in the window.
`Window.setup` splits set-up by phase.
"""

from __future__ import annotations

import dataclasses
import time

import torch

# profiled calls (or frames) before a traced stretch opens: the first
# calls under a new profiler pay its start-up
WARM_CALLS = 2
# calls (frames) in the traced stretch
TRACE_CALLS = 16
TRACE_FRAMES = 4
# stream: the host waits on the event this many calls back
LAG = 2
# stream: set-up's calls, the capture from each buffer set and two
# replays of each; view: set-up's frames
SETUP_CALLS = 6
SETUP_FRAMES = 3


@dataclasses.dataclass
class Window:
    end_to_end: dict            # e2e metric name -> value
    count: int                  # steps (stream) or frames (view) done
    samples: list               # for check.judge
    memory_peak_bytes: int
    spans: dict                 # harness host spans, seconds each
    trace: object = None        # trace.Summary of the traced stretch
    setup_s: float = 0.0
    times: list = None          # seconds of each step (stream) or frame
    setup: list = None          # (phase, host clock at its end)
    seconds: float = None       # the window's length (multi-card loops)
    mesh: object = None         # the program's mesh (multi-card loops)


def program_config(fields: dict):
    """The program's FluidConfig from a configuration file's fields."""
    from tpu_fluid_torch.core.config import FluidConfig, deep_tuple
    return FluidConfig(**{k: deep_tuple(v) for k, v in fields.items()})


def as_state(fields: dict):
    from tpu_fluid_torch.core.state import FluidState
    return FluidState(**fields)


class Clock:
    """CUDA events on the card's stream; host clock marks on the CPU
    (which only the tests run)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def wait(self, mark) -> None:
        if self.cuda:
            mark.synchronize()

    def seconds(self, a, b) -> float:
        if not self.cuda:
            return b - a
        return a.elapsed_time(b) / 1000.0


def _host(state) -> dict:
    return {k: v.detach().to("cpu") for k, v in state._asdict().items()}


def _clone(state) -> dict:
    return {k: v.clone() for k, v in state._asdict().items()}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _context(device) -> None:
    """Create the device's context now, so that set-up's split shows it."""
    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(0, device=device)
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def run(traffic: dict, fields: dict, seed: int, seconds: float,
        trace: bool, device: torch.device, t0: float, ranks=None,
        root=None) -> Window:
    """One run of the mix on the configuration; `t0` is the host clock at
    the process's start, from which set-up is counted.  `ranks` is this
    process's place among a multi-card cell's ranks; `root` the checkout
    whose `fluid_bench/loops/` holds the loop."""
    from fluid_bench.manifest import loop_module
    loop = loop_module(traffic["loop"], root)
    if ranks is not None and not getattr(loop, "MULTI_CARD", False):
        raise ValueError(f"the loop {traffic['loop']!r} runs on one card")
    return loop.run(traffic, fields, seed, seconds, trace, device, t0,
                    ranks=ranks)
