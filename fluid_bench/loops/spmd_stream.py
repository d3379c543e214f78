"""spmd_stream: the offline run on a sharded scene, one rank a card.

Every rank replays `jit_spmd_step(cfg, mesh)` back to back from its share
of the seeded state, nothing read back.  The share is the slab seed's
x-planes of the grid fields (`state.initial(..., x_range=)`, so no card
builds the whole grid) and the particles as the program lays them out for
the configuration's `particle_sharding` (`particles_domain.layout_state`).

Every collective inside the step has to see the same number of calls on
every rank, so the window's call count is fixed in set-up: rank 0 times
set-up's warm replays and turns `--seconds` into a count, which one
broadcast hands to every rank; nothing syncs inside the window.  As in
`stream`, a CUDA event is recorded after each call and the host waits on
the event `LAG` calls back.  Under `--trace 1` every rank traces the same
stretch of calls.

Samples, each rank's part: the start, the window's last step, and one
call after the window from a copy of its input.  `run.py` merges the
ranks' windows by `end_to_end` below.
"""

from __future__ import annotations

import math
import time

import torch

from fluid_bench import stats
from fluid_bench.loop import (LAG, SETUP_CALLS, TRACE_CALLS, WARM_CALLS,
                              Clock, Window, _clone, _context, _host, _peak,
                              _sync, program_config)
from fluid_bench.state import initial, slab
from fluid_bench.trace import Stretch, span

MULTI_CARD = True
# set-up's calls after the two captures, timed for the window's count
RATE_CALLS = SETUP_CALLS - 2


def end_to_end(count: int, seconds: float, times: list) -> dict:
    """The cell's end-to-end metrics from a window of `count` calls
    lasting `seconds`, and each call's seconds."""
    return {"steps_per_s": stats.rate(count, seconds),
            "step_ms_p95": stats.percentile(times, 95) * 1e3}


def share(fields: dict, seed: int, device, cfg, rank: int, size: int):
    """This rank's share of the seeded state, as the program's FluidState.
    `layout_state` cuts a whole state; it is given the whole particle set
    and, of each grid field, one plane per rank (a broadcast view), and
    the slab seed's planes replace the plane it cuts."""
    from tpu_fluid_torch.core.state import FluidState
    from tpu_fluid_torch.parallel.mesh import SLAB_FIELDS
    from tpu_fluid_torch.parallel.particles_domain import layout_state
    part = initial(fields, seed, device, x_range=slab(fields, rank, size))
    probe = {}
    for k, v in part.items():
        if k in SLAB_FIELDS:
            dim = 1 if k == "velocity" else 0
            shape = list(v.shape)
            shape[dim] = size
            v = v.narrow(dim, 0, 1).expand(shape)
        probe[k] = v
    cut = layout_state(FluidState(**probe), rank, size, cfg)
    return cut._replace(**{k: part[k] for k in SLAB_FIELDS})


def window_calls(seconds: float, per_call: float, mesh, device) -> int:
    """Rank 0's count of calls for a window of `seconds`, on every rank."""
    import torch.distributed as dist
    count = max(1, math.ceil(seconds / max(per_call, 1e-9)))
    t = torch.tensor([count], dtype=torch.int64, device=device)
    dist.broadcast(t, 0, group=mesh.group)
    return int(t.item())


def run(traffic, fields, seed, seconds, trace, device, t0,
        ranks=None) -> Window:
    if ranks is None:
        raise ValueError("spmd_stream runs on the ranks of a cell with "
                         "\"chips\" > 1")
    from tpu_fluid_torch.parallel.mesh import make_mesh
    from tpu_fluid_torch.parallel.spmd_step import jit_spmd_step
    setup = [("import program", time.perf_counter())]
    cfg = program_config(fields)
    rank, size = ranks.rank, ranks.size
    _context(device)
    setup.append(("device context", time.perf_counter()))
    mesh = make_mesh(size, rank, ranks.init_method, device=device,
                     backend=ranks.backend)
    call = jit_spmd_step(cfg, mesh)
    setup.append(("mesh", time.perf_counter()))
    s = share(fields, seed, device, cfg, rank, size)
    _sync(device)
    setup.append(("seeded state", time.perf_counter()))
    # set-up: the graph from set A (its result kept for the start check),
    # the graph from set B, then RATE_CALLS timed replays
    s = call(s)
    _sync(device)
    setup.append(("first call", time.perf_counter()))
    start = _host(s)
    setup.append(("start sample", time.perf_counter()))
    s = call(s)
    _sync(device)
    a = time.perf_counter()
    for _ in range(RATE_CALLS):
        s = call(s)
    _sync(device)
    count = window_calls(seconds, (time.perf_counter() - a) / RATE_CALLS,
                         mesh, device)
    setup.append(("warm calls", time.perf_counter()))
    clock = Clock(device)
    stretch = Stretch(device, WARM_CALLS, TRACE_CALLS) if trace else None
    if stretch is not None:
        stretch.start()
    window_start = time.perf_counter()
    setup_s = window_start - t0
    marks = [clock.mark()]
    prev = None
    for calls in range(1, count + 1):
        traced = stretch is not None and stretch.on()
        with span("jit_step", traced):
            prev, s = s, call(s)
        marks.append(clock.mark())
        if len(marks) > LAG:
            with span("wait", traced):
                clock.wait(marks[-1 - LAG])
        if stretch is not None:
            stretch.advance(calls)
    peak = _peak(device)
    _sync(device)
    times = [clock.seconds(a, b) for a, b in zip(marks, marks[1:])]
    window = clock.seconds(marks[0], marks[-1])
    summary = stretch.read() if stretch is not None else None
    # after the window: the last step is checked, and one more call, from
    # a copy of its input (the call overwrites the last step's input)
    kept = _clone(prev)
    last = call(s)
    _sync(device)
    made = SETUP_CALLS + count
    samples = [{"input": None, "seed": seed, "output": start, "steps": 1},
               {"input": kept, "output": s._asdict(), "steps": made},
               {"input": s._asdict(), "output": last._asdict(),
                "steps": made + 1}]
    return Window(
        end_to_end=end_to_end(count, window, times), count=count,
        samples=samples, memory_peak_bytes=peak, spans={}, trace=summary,
        setup_s=setup_s, times=times, setup=setup, seconds=window,
        mesh=mesh)
