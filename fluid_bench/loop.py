"""The one traffic generator: it reads a traffic mix's parameters and
drives the program through one run, set-up and window.

Two loops, chosen by the mix's `loop`:

  stream  `jit_step` back to back on one lineage, nothing read back.  A
          CUDA event is recorded on the stream after each call; the host
          waits on the event `LAG` calls back, so it runs at most that far
          ahead and the run ends near `--seconds`.
  view    the reference's frame loop, closed, one viewer: per frame
          `Simulation.step(1)`, a splat `render_frame(width, height)` with
          particles and surface, and `to_host`; the next frame is asked
          for once the image is in host memory.

Set-up captures both of the lineage's graphs and warms every shape the
window uses; the first call's result is kept on the host for the check of
the start.  The window's samples for the check: the stream's last step,
and one more call after the window from a copy of its input (the graph
from the other buffer set); the viewer's frame drawn from the seed among
its first 32 and its last frame, each with the mesh that frame was drawn
from.  Each sample carries the number of steps the run made up to it,
which the state's step counter has to equal.  In a traced run
(`--trace 1`) the profiler is on for the window's first `WARM_CALLS` +
`TRACE_CALLS` calls (or frames: `TRACE_FRAMES`), and the stretch read is
the last `TRACE_CALLS` of them; the time spent starting and stopping it is
not counted in the window.  `Window.setup` splits set-up by phase.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from fluid_bench import stats
from fluid_bench.state import generator, initial
from fluid_bench.trace import Stretch, span

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
        trace: bool, device: torch.device, t0: float) -> Window:
    """One run of the mix on the configuration; `t0` is the host clock at
    the process's start, from which set-up is counted."""
    loop = {"stream": _stream, "view": _view}[traffic["loop"]]
    return loop(traffic, fields, seed, seconds, trace, device, t0)


def _stream(traffic, fields, seed, seconds, trace, device, t0) -> Window:
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


def _view(traffic, fields, seed, seconds, trace, device, t0) -> Window:
    from tpu_fluid_torch.engine import Simulation
    from tpu_fluid_torch.render.export import to_host
    setup = [("import program", time.perf_counter())]
    cfg = program_config(fields)
    w, h = int(traffic["width"]), int(traffic["height"])
    _context(device)
    setup.append(("device context", time.perf_counter()))
    sim = Simulation(cfg, state=as_state(initial(fields, seed, device)),
                     device=str(device))
    sim.sync()
    setup.append(("seeded state", time.perf_counter()))
    spans = {"render": []}
    # the mesh the newest frame was drawn from, kept for the check
    drawn = {}
    surface_mesh = sim.surface_mesh

    def held_mesh():
        drawn["mesh"] = surface_mesh()
        return drawn["mesh"]
    sim.surface_mesh = held_mesh

    def frame(traced):
        prev = sim.state
        with span("step", traced):
            sim.step(1)
        a = time.perf_counter()
        with span("render_frame", traced):
            img = sim.render_frame(w, h, method="splat")
        with span("to_host", traced):
            host = to_host(img)
        spans["render"].append((time.perf_counter() - a, traced))
        return prev, host

    def mesh():
        m = drawn["mesh"]
        return m.vertices, m.normals, m.valid

    _, image = frame(False)
    setup.append(("first call", time.perf_counter()))
    start = {"input": None, "seed": seed, "output": _host(sim.state),
             "steps": 1, "image": image,
             "mesh": tuple(t.to("cpu") for t in mesh())}
    setup.append(("start sample", time.perf_counter()))
    for _ in range(SETUP_FRAMES - 1):
        frame(False)
    sim.sync()
    setup.append(("warm calls", time.perf_counter()))
    spans["render"].clear()
    pick = int(torch.randint(0, 32, (1,), generator=generator(seed, "cpu")))
    stretch = Stretch(device, WARM_CALLS, TRACE_FRAMES) if trace else None
    if stretch is not None:
        stretch.start()
    window_start = time.perf_counter()
    setup_s = window_start - t0
    times = []
    samples = [start]
    frames = 0
    while True:
        traced = stretch is not None and stretch.on()
        a = time.perf_counter()
        prev, image = frame(traced)
        times.append(time.perf_counter() - a)
        frames += 1
        if frames - 1 == pick:
            samples.append({"input": _clone(prev),
                            "output": _clone(sim.state),
                            "steps": SETUP_FRAMES + frames, "image": image,
                            "mesh": mesh()})
        if stretch is not None:
            stretch.advance(frames)
        paused = stretch.paused if stretch is not None else 0.0
        if time.perf_counter() - window_start - paused >= seconds and \
                frames > pick:
            break
    window = time.perf_counter() - window_start - paused
    sim.sync()
    peak = _peak(device)
    summary = stretch.read() if stretch is not None else None
    samples.append({"input": prev._asdict(), "output": sim.state._asdict(),
                    "steps": SETUP_FRAMES + frames, "image": image,
                    "mesh": mesh()})
    return Window(
        end_to_end={"frames_per_s": stats.rate(frames, window),
                    "frame_ms_p95": stats.percentile(times, 95) * 1e3},
        count=frames, samples=samples, memory_peak_bytes=peak,
        spans={"render": [t for t, traced in spans["render"] if not traced]},
        trace=summary, setup_s=setup_s, times=times, setup=setup)
