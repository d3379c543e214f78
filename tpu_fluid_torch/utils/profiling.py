"""Timing of the port (`tpu_fluid.utils.profiling`): its spans, the steps/s
measurement and a per-stage-group breakdown.

Spans.  `tracing(True)` turns the program's spans on, `tracing(False)`
off; `report()` returns what was recorded and `reset()` clears it.  With
tracing off, `span(name)` returns one shared null context and `stages()`
one shared no-op, after reading a module global: no event, no clock, no
dispatcher call.  With tracing on:

  - an eager span opens `torch.profiler.record_function("tpu_fluid.<name>")`,
    so that it lies on the profiler's clock beside the device's work; adds
    its host seconds, and its self seconds (less the host seconds of the
    spans inside it), to the registry under its name, with its parent's
    name; and, once CUDA is in use, records a timing event on the current
    stream at each end, read when `report()` flushes: the stream's ms from
    the span's start to its end;
  - under a CUDA-graph capture that `capture()` collects (`solver/graph`'s),
    a span records a timed external event at each end, an event-record
    node of the graph; `Marks.replay` reads a replay's times before the
    graph replays again, and `report()` reads the last;
  - PyTorch's sync debug mode is "warn", and each synchronizing-op warning
    it gives counts under the innermost open span (`syncs`) and is not
    shown.  `tracing(False)` puts the mode and the warning filters back.

`stages()` marks the step's stage groups, which tile it, at their
boundaries: one event a boundary, shared by the group that ends and the
one that begins.

Counters.  `count(name, n)` adds a host number (say the bytes of an
exchange, from its shapes) and `count_on_device(name, n)` a device scalar
(say the particles a migration sent), with no host sync: into an int64
accumulator on the device, which `report()` reads and clears.  Each is a
record under the innermost open span: `count` its total, `calls` its
additions.  Under a collected capture an addition belongs to the graph:
each replay read adds `n` again (the device one adds on the device, so the
replay itself counts).  With tracing off both return at once.

Timers.  Every timer chains its iterations, x_{k+1} = f(x_k).  On the card
the n iterations are captured into one CUDA graph, the counterpart of JAX's
`lax.fori_loop` inside one program, and a replay is timed by CUDA events
after one untimed replay: the host's dispatch of each op does not show.
On the CPU the host clock times n eager calls after one untimed call.
`stage_breakdown` reads the stage spans of n steps: graphed replays on the
card, eager steps on the CPU.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
import warnings
from typing import Callable, Dict

import torch

from tpu_fluid_torch.core.config import FluidConfig

TOTAL = "TOTAL full step"
PREFIX = "tpu_fluid."
# the start of the warning PyTorch gives in sync debug mode "warn"
SYNC_WARNING = "called a synchronizing CUDA operation"


@dataclasses.dataclass
class _Record:
    """What a span's name has recorded: `calls` closes (eager) or replays
    read (graph), host and self seconds (eager), the device ms its events
    measured over `device_calls` readings, and host syncs."""
    parent: str | None
    calls: int = 0
    host_s: float = 0.0
    self_s: float = 0.0
    device_ms: float = 0.0
    device_calls: int = 0
    syncs: int = 0
    count: int | float = 0


_ON = False
_NULL = contextlib.nullcontext()
_RECORDS: Dict[str, _Record] = {}
_STACK: list = []                    # the open spans, innermost last
_EAGER: collections.deque = collections.deque()   # events not yet read
_PENDING: set = set()                # Marks replayed and not yet read
_CAPTURE = None                      # the Marks of the graph in capture
# (counter name, parent, device) -> its int64 accumulator on the device
_DEVICE_COUNTS: dict = {}
_SAVED: tuple | None = None          # what tracing(False) puts back


def enabled() -> bool:
    return _ON


def tracing(on: bool) -> None:
    """Turn the program's spans on or off (module docstring)."""
    global _ON, _SAVED
    if on == _ON:
        return
    if on:
        filters = warnings.catch_warnings()
        filters.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)
        shown = warnings.showwarning

        def count(message, category, filename, lineno, file=None,
                  line=None):
            if str(message).startswith(SYNC_WARNING):
                if _STACK:
                    _record(_STACK[-1].name, _STACK[-1].parent).syncs += 1
                return
            shown(message, category, filename, lineno, file, line)
        warnings.showwarning = count
        mode = None
        if torch.cuda.is_available():
            mode = torch.cuda.get_sync_debug_mode()
            _set_sync_debug_mode("warn")
        _SAVED = (filters, mode)
    else:
        filters, mode = _SAVED
        if mode is not None:
            _set_sync_debug_mode(mode)
        filters.__exit__(None, None, None)
        _SAVED = None
        _STACK.clear()
    _ON = on


def _set_sync_debug_mode(mode) -> None:
    # without the notice that the mode is a prototype, each time it is set
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode(mode)


def report() -> Dict[str, dict]:
    """Every span's record by name, in the order first recorded, after
    reading every event still pending."""
    flush()
    return {name: dataclasses.asdict(r) for name, r in _RECORDS.items()}


def reset() -> None:
    """Forget what was recorded and every reading still pending."""
    for marks in list(_PENDING):
        marks.replayed = False
    _PENDING.clear()
    _EAGER.clear()
    _RECORDS.clear()
    # kept, since captured graphs add into them
    for acc in _DEVICE_COUNTS.values():
        acc.zero_()


def span(name: str):
    """A span of the program's work (module docstring)."""
    if not _ON:
        return _NULL
    return _Span(name)


def _no_stage(name: str | None = None) -> None:
    pass


def stages():
    """A marker of stage groups that tile a stretch of work: called with a
    group's name it ends the open group and begins that one, at one
    boundary; called with none it ends the open group."""
    if not _ON:
        return _no_stage
    return _Stages()


def _parent() -> str | None:
    return _STACK[-1].name if _STACK else None


def count(name: str, n) -> None:
    """Add the host number `n` to counter `name` (module docstring)."""
    if not _ON:
        return
    if _capturing():
        if _CAPTURE is not None:
            _CAPTURE.counts.append((name, _parent(), n))
        return
    rec = _record(name, _parent())
    rec.calls += 1
    rec.count += n


def count_on_device(name: str, n: torch.Tensor) -> None:
    """Add the device scalar `n` to counter `name`, with no host sync
    (module docstring)."""
    if not _ON:
        return
    parent = _parent()
    captured = _capturing()
    if captured and _CAPTURE is None:
        return
    key = (name, parent, n.device)
    acc = _DEVICE_COUNTS.get(key)
    if acc is None:
        # made at the eager warm-up before a traced capture, outside any
        # graph's pool
        acc = _DEVICE_COUNTS[key] = torch.zeros((), dtype=torch.int64,
                                                device=n.device)
    acc.add_(n)
    if captured:
        _CAPTURE.counts.append((name, parent, None))
    else:
        _record(name, parent).calls += 1


class _Span:
    __slots__ = ("name", "open")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.open = _begin(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        _end(self.open)
        return False


class _Stages:
    __slots__ = ("open",)

    def __init__(self):
        self.open = None

    def __call__(self, name: str | None = None) -> None:
        event = _end(self.open) if self.open is not None else None
        self.open = None if name is None else _begin(name, event)


class _Open:
    """An open span."""
    __slots__ = ("name", "parent", "captured", "start", "child_s", "range",
                 "t0")

    def __init__(self, name: str, start, captured: bool):
        self.name = name
        self.parent = _parent()
        self.captured = captured
        self.start = start
        self.child_s = 0.0
        if not captured:
            self.range = torch.profiler.record_function(PREFIX + name)
            self.range.__enter__()
        _STACK.append(self)
        self.t0 = time.perf_counter()

    def close(self, end) -> None:
        host = time.perf_counter() - self.t0
        if self in _STACK:
            # spans a raised exception left open inside it end with it
            del _STACK[_STACK.index(self):]
        if self.captured:
            _CAPTURE.spans.append((self.name, self.parent, self.start, end))
            return
        self.range.__exit__(None, None, None)
        rec = _record(self.name, self.parent)
        rec.calls += 1
        rec.host_s += host
        rec.self_s += host - self.child_s
        if _STACK:
            _STACK[-1].child_s += host
        if self.start is not None:
            _EAGER.append((self.name, self.parent, self.start, end))
            while _EAGER and _EAGER[0][3].query():
                _book(*_EAGER.popleft())


def _record(name: str, parent: str | None) -> _Record:
    rec = _RECORDS.get(name)
    if rec is None:
        rec = _RECORDS[name] = _Record(parent)
    return rec


def _capturing() -> bool:
    return torch.cuda.is_initialized() and \
        torch.cuda.is_current_stream_capturing()


def _event(captured: bool) -> torch.cuda.Event:
    event = torch.cuda.Event(enable_timing=True, external=captured)
    event.record()
    return event


def _begin(name: str, start=None) -> _Open | None:
    """Open span `name`, with `start` as its start event where given.
    Under a capture that no `capture()` collects it records nothing."""
    captured = _capturing()
    if captured and _CAPTURE is None:
        return None
    if start is None and (captured or torch.cuda.is_initialized()):
        start = _event(captured)
    return _Open(name, start, captured)


def _end(open_: _Open | None):
    """Close a span; returns its end event, if it has one."""
    if open_ is None:
        return None
    end = _event(open_.captured) if open_.start is not None else None
    open_.close(end)
    return end


def _book(name: str, parent: str | None, start, end) -> None:
    rec = _record(name, parent)
    rec.device_ms += start.elapsed_time(end)
    rec.device_calls += 1


def flush() -> None:
    """Read every event still pending: each graph's last replay, the
    eager spans', and the device counters (a sync each)."""
    for marks in list(_PENDING):
        marks.read()
    while _EAGER:
        name, parent, start, end = _EAGER.popleft()
        end.synchronize()
        _book(name, parent, start, end)
    for (name, parent, _), acc in _DEVICE_COUNTS.items():
        n = int(acc.item())
        if n:
            _record(name, parent).count += n
            acc.zero_()


class Marks:
    """The spans captured into one CUDA graph, (name, parent, start event,
    end event) in the order they closed, and its counters' additions,
    (name, parent, host number or None for a device counter)."""

    def __init__(self):
        self.spans = []
        self.counts = []
        self.replayed = False

    def replay(self, graph) -> None:
        """Replay `graph`, having read its previous replay's times: the
        replay records its events anew."""
        self.read()
        graph.replay()
        if self.spans or self.counts:
            self.replayed = True
            _PENDING.add(self)

    def read(self) -> None:
        """Book the last replay's times and counts, once its last event is
        done."""
        if not self.replayed:
            return
        if self.spans:
            self.spans[-1][3].synchronize()
        for name, parent, start, end in self.spans:
            _book(name, parent, start, end)
            _record(name, parent).calls += 1
        for name, parent, n in self.counts:
            rec = _record(name, parent)
            rec.calls += 1
            if n is not None:
                rec.count += n
        self.replayed = False
        _PENDING.discard(self)


@contextlib.contextmanager
def capture():
    """Collect the spans of the CUDA-graph capture run inside: yields
    their `Marks`."""
    global _CAPTURE
    marks = Marks()
    _CAPTURE = marks
    try:
        yield marks
    finally:
        _CAPTURE = None


# ------------------------------------------------------------------ timers
@torch.no_grad()
def time_chained(f: Callable, x0, n: int = 10) -> float:
    """Milliseconds per call of the self-map f over n chained calls
    (x_{k+1} = f(x_k)); x0 is a tensor or a tuple of tensors, which f does
    not modify in place."""
    device = (x0 if isinstance(x0, torch.Tensor) else x0[0]).device
    if device.type != "cuda":
        f(x0)
        t0 = time.perf_counter()
        x = x0
        for _ in range(n):
            x = f(x)
        return (time.perf_counter() - t0) / n * 1000.0
    with torch.cuda.device(device):
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            f(x0)                       # fills the host-side caches
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            x = x0
            for _ in range(n):
                x = f(x)
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / n


def time_step(cfg: FluidConfig, n: int = 20, state=None) -> float:
    """ms per full simulation step (from `initial_state(cfg)`, on the card,
    unless a state is given)."""
    from tpu_fluid_torch.core.state import initial_state
    from tpu_fluid_torch.solver.step import simulation_step
    if state is None:
        state = initial_state(cfg)
    return time_chained(lambda s: simulation_step(s, cfg), state, n=n)


def stage_breakdown(cfg: FluidConfig, n: int = 10, warm_steps: int = 3,
                    device="cuda") -> Dict[str, float]:
    """ms a step of each stage group of the step (`solver/step.py`), read
    from its stage spans over n steps from the state after `warm_steps`
    steps: on the card the device ms of n `jit_step` replays, after both
    of the lineage's graphs were captured and replayed once; on the CPU
    the host ms of n eager steps, after one.  `TOTAL full step` is
    `time_step`'s.  It clears the registry and leaves tracing as it was;
    the traced graphs stay in `solver/graph`'s cache until
    `clear_graphs()`.  JAX's keys map onto the groups so:

      JAX                              the port, unfused path
      01+15 occupancy scatter    ->    15 in "14+15 move and scatter" (the
                                       scatter is in K3+K4), 01's max-pool
                                       in "01-03 pool and cell typing"
      02+03 cell typing          ->    "01-03 pool and cell typing"
      04+05 extrapolate          ->    "04+05 extrapolate" (and 06)
      07 advect                  ->    "07 advect" (K1)
      08-10 forces/solids        ->    "08-10 forces/solids"
      11 divergence              ->    "11 divergence"
      12 jacobi xN               ->    "12 jacobi xN" (K2f and K2)
      13 project                 ->    "13 project"
      14 move particles          ->    "14+15 move and scatter" (K3+K4)
      16-18 surface fields       ->    "16-18 surface fields" (K5 and its
                                       skip mask, and the step counter)
      TOTAL full step            ->    "TOTAL full step"

    Where `fuse_grid_choice` holds (256^3), the K6 groups replace five of
    them: "01-06 classify and extrapolate (K6a)" takes 01-05,
    "08-11 forces, solids, divergence (K6b)" takes 08-10 and 11, and
    "13 project (K6c)" takes 13."""
    from tpu_fluid_torch.core.state import initial_state
    from tpu_fluid_torch.solver.graph import jit_step
    from tpu_fluid_torch.solver.step import step

    state = initial_state(cfg, device)
    for _ in range(warm_steps):
        state = step(state, cfg)
    total = time_step(cfg, n=n, state=state)
    cuda = state.velocity.device.type == "cuda"
    was = enabled()
    tracing(True)
    try:
        run = jit_step if cuda else step
        s = run(state, cfg)
        if cuda:
            s = run(run(s, cfg), cfg)
        reset()
        for _ in range(n):
            s = run(s, cfg)
        groups = report()
    finally:
        tracing(was)
    out = {name: (r["device_ms"] / r["device_calls"] if cuda
                  else r["host_s"] * 1e3 / r["calls"])
           for name, r in groups.items()}
    out[TOTAL] = total
    return out


def print_breakdown(cfg: FluidConfig, n: int = 10, device="cuda") -> None:
    bd = stage_breakdown(cfg, n=n, device=device)
    total = bd.get(TOTAL, 0.0)
    print(f"grid={cfg.grid_size} particles={cfg.particle_count} "
          f"jacobi={cfg.jacobi_iters} detailed={cfg.detailed_size}")
    for k, v in bd.items():
        frac = f" ({100 * v / total:4.0f}%)" if total and k != TOTAL else ""
        print(f"  {k:40s} {v:8.3f} ms{frac}")
