"""view: the reference's frame loop, closed, one viewer, on one card.

Per frame `Simulation.step(1)`, a splat `render_frame(width, height)` with
particles and surface, and `to_host`; the next frame is asked for once the
image is in host memory.  Set-up draws `SETUP_FRAMES` frames.  The window's
samples: the start, the frame drawn from the seed among its first 32 and
its last frame, each with the mesh that frame was drawn from.
"""

from __future__ import annotations

import time

import torch

from fluid_bench import stats
from fluid_bench.loop import (SETUP_FRAMES, TRACE_FRAMES, WARM_CALLS,
                              Window, _clone, _context, _host, _peak,
                              as_state, program_config)
from fluid_bench.state import generator, initial
from fluid_bench.trace import Stretch, span


def run(traffic, fields, seed, seconds, trace, device, t0,
        ranks=None) -> Window:
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
        # the previous frame's host image is let go before this frame
        # copies its own: held through the copy, it made some processes'
        # frames 10-20% slower than others'
        image = None
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
