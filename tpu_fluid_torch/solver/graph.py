"""The step as a CUDA graph: `jit_step` and `jit_multi_step`, the
counterparts of `tpu_fluid/solver/step.py:jit_step` and `jit_multi_step`.

JAX compiles a step, or `lax.scan` over n steps, into one XLA program that
the host dispatches once.  The port's eager step launches a few hundred
PyTorch ops and kernels from Python, one by one.  Here a call for a
(config, n, device, field shapes and dtypes) replays a CUDA graph of n
steps: one host call for n steps.

Each such key holds a few entries, one a live lineage.  An entry holds two
buffer sets, A and B, each a whole state; the graphs that step between
them (the one reading A writes its last step into B, the one reading B
writes into A); the scene buffers both read; and the step its lineage's
set holds.  A call on a CUDA state

  - replays the graph of the entry and set whose buffers the state is
    (every field's `data_ptr`), as `jit_step(jit_step(s))` does on one
    lineage, and returns the other set;
  - else takes a free entry of the key and copies the state into its set
    A, or makes a new entry: set A cloned from the state, set B empty.
    The first call of a key runs one eager step on a side stream before
    its capture, which builds the kernels and fills every cache a step
    fills on the host (launch plans, the K6 constant tables).

Each graph is captured when first needed (the one reading set B at the
lineage's second call): n steps of the `Program` from its set, the n-th
given the other set as `into`, so that each field's last writer (K6c or
the stage-13 stack, K6a or stage 03, K3+K4, K5, the step counter) writes
it there.  The graph ends by copying any field that did not land there
(`_load`: the residual hand-over, which `captures` records by field and
bytes; none on the single-device or the sharded step's path).  A field
the program passes through unchanged (`active`, `dropped`, the surface
fields with the surface off, the inertia under the level set) is one
tensor of both sets, found at the entry's first capture.  The graphs of
an entry share one private memory pool: they never run at once, and no
tensor of the pool is read after a replay, since the state then lives in
a set.

Donation, as `donate_argnums=0` in JAX: a state passed to a call is
consumed, and a call given any other state never writes it.  The returned
tensors are new tensor objects over the set a graph wrote, and the entry
keeps weak references to them.  So `s2 = jit_step(s1)` lies in the other
set from `s1`; `s1` keeps its values until `s2` is passed in, and
`jit_step(s2)` writes `s1`'s buffers.  An entry is free once none of the
tensors it last returned is held (a view taken of one holds it), or once
that state was passed to a call, which consumes it.  So two live states
of one key (two `Simulation`s, or one beside a loaded checkpoint) step in
entries of their own, and a dropped lineage's entry is reused rather than
captured again.  A state that is no entry's set is copied in and left as
it was.

A scene (`core/scene_fields.SceneFields`) is a graph input like the
state: the graph reads it from buffers of its own, which every call fills
with the scene it is given, and never writes it.

Volume correction every K > 1 steps (`volume_correction_every`) runs on
the steps with `step % K == 0` only, one branch as JAX's `lax.cond`.  A
capture cannot read the step on the host, so an entry holds its graphs by
(set read, phase `step % K` of the first step), with the schedule of the
n steps unrolled into each: at most 2K graphs an entry.  A lineage under
the cadence stays in its entry.  Each entry knows the step of its
lineage's set; the host reads the step of any other state once, before
the replay.

The step a graph records is its `Program`: the single-device
`simulation_step`, or one shard's step of the x-slab layout bound to its
mesh (`parallel/spmd_step.jit_spmd_step`, `jit_spmd_multi_step`, JAX's
jitted `spmd_step` and `spmd_multi_step`).  The program's key (the
mesh's rank, size, backend and device) is part of the graph key; every
rule above holds for both.  On an nccl mesh the collectives are captured
too: the warm-up step creates the communicators, and every rank captures
the same sequence of collectives, since each takes the same branches.

With tracing on (`utils/profiling`), a call takes graphs of its own: the
tracing flag is part of the key, so an untraced graph holds no span.  A
traced capture collects the step's stage spans, timed event-record nodes
of the graph, and each replay reads the times of the same graph's
previous replay first; `clear_graphs` reads the last.

A failed capture or replay raises; nothing falls back to the eager step on
the card.  The kernel wrappers' launch counters count the kernels they
launch at the warm-up step and in the captures, not the replays.  On a CPU
state (the caller's choice, as in the tests) the functions run the eager
step n times.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Callable

import torch

from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.core.state import FluidState
from tpu_fluid_torch.kernels import on_cuda
from tpu_fluid_torch.solver.step import simulation_step
from tpu_fluid_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class Program:
    """The step a graph records: `step(state, cfg, scene, volume_step,
    into=None)` returns the next state, reading `state.step` on the host
    only where `volume_step` is None, and writing each new field into
    `into`'s where one is given; `key` tells its graphs apart from other
    programs' (None for the single-device step); `capture_error_mode` is
    passed to `torch.cuda.graph`."""
    step: Callable
    key: tuple | None = None
    capture_error_mode: str = "global"


SINGLE_DEVICE = Program(simulation_step)


@dataclasses.dataclass(eq=False)
class _Entry:
    """A lineage's two buffer sets, the graphs that step between them and
    the scene buffers they read."""
    sets: list                    # [A, B]: two FluidStates
    scene_buffers: object = None
    # (source set, phase of the cadence at the first step) -> graph
    graphs: dict = dataclasses.field(default_factory=dict)
    # the same key -> the spans a traced graph captured (profiling.Marks)
    marks: dict = dataclasses.field(default_factory=dict)
    pool: object = None           # the private memory pool its graphs share
    step: int | None = None       # the step the lineage's set holds
    held: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.ptrs = [_ptrs(s) for s in self.sets]

    @classmethod
    def of(cls, state: FluidState, scene) -> "_Entry":
        """A new entry: set A a copy of `state`, set B empty."""
        return cls([FluidState(*(t.clone() for t in state)),
                    FluidState(*(torch.empty_like(t) for t in state))],
                   None if scene is None else type(scene)(
                       *(None if t is None else t.clone() for t in scene)))

    def into(self, src: int) -> FluidState:
        """The set a graph reading set `src` writes, with None for the
        fields both sets share."""
        return FluidState(*(None if s is d else d for s, d in
                            zip(self.sets[src], self.sets[1 - src])))

    def share(self, src: int, fields) -> None:
        """Make `fields` (indices) one tensor, set `src`'s, in both sets."""
        other = self.sets[1 - src]
        for i in fields:
            other = other._replace(**{FluidState._fields[i]:
                                      self.sets[src][i]})
        self.sets[1 - src] = other
        self.ptrs = [_ptrs(s) for s in self.sets]

    def free(self) -> bool:
        """No state this entry returned is still held, or it was passed
        to a call."""
        return all(ref() is None for ref in self.held)


# key -> [_Entry]
_GRAPHS: dict = {}
# keys whose eager warm-up step has run
_WARM: set = set()
# one record a capture: the scene's grid, n, the phase of the volume
# cadence (None without one), the set the graph reads, the warm-up step's
# seconds (0.0 after the key's first capture) and the capture's, the device
# memory the capture added to its entry's pool, and the residual hand-over:
# the fields the graph ends by copying into the other set, and their bytes
captures: list = []


def _fields(tensors) -> tuple:
    return tuple(None if t is None else (tuple(t.shape), t.dtype)
                 for t in tensors)


def _ptrs(state) -> tuple:
    return tuple(t.data_ptr() for t in state)


def _key(state: FluidState, cfg: FluidConfig, n_steps: int, scene,
         program: Program) -> tuple:
    return (program.key, cfg, n_steps, state.velocity.device,
            _fields(state), None if scene is None else _fields(scene),
            profiling.enabled())


def _load(buffers, values) -> None:
    """Copy each tensor of `values` that is not already the buffer's
    own (None entries, a scene's absent field, are skipped)."""
    for dst, src in zip(buffers, values):
        if src is not None and src.data_ptr() != dst.data_ptr():
            dst.copy_(src)


def _alias(t: torch.Tensor) -> torch.Tensor:
    """A new tensor object over `t`'s memory.  It is no view of `t`, so a
    view taken of it keeps it alive."""
    return torch.empty(0, dtype=t.dtype, device=t.device).set_(
        t.untyped_storage(), t.storage_offset(), t.shape, t.stride())


def _owner(state: FluidState) -> tuple:
    """(the entry one of whose sets `state` is, of any key, and the set's
    index), else (None, None)."""
    ptrs = _ptrs(state)
    for entries in _GRAPHS.values():
        for entry in entries:
            if ptrs in entry.ptrs:
                return entry, entry.ptrs.index(ptrs)
    return None, None


def _record(entry: _Entry, src: int, cfg: FluidConfig, n_steps: int,
            first: int, program: Program) -> list:
    """What a graph runs: n steps of `program` from set `src`, the last
    written into the other set by each field's last writer, then the
    residual hand-over, a copy of each field that did not land there.  At
    an entry's first graph the fields the program passed through become
    one tensor of both sets.  Returns the residual fields' names."""
    out = entry.sets[src]
    for k in range(n_steps):
        # the step number unrolls the volume cadence; no host read
        out = program.step(out, cfg, entry.scene_buffers, first + k,
                           entry.into(src) if k == n_steps - 1 else None)
    if not entry.graphs:
        entry.share(src, [i for i, (o, s) in
                          enumerate(zip(out, entry.sets[src])) if o is s])
    dst = entry.sets[1 - src]
    _load(dst, out)
    return [name for name, o, d in zip(FluidState._fields, out, dst)
            if o.data_ptr() != d.data_ptr()]


def _capture(entry: _Entry, src: int, cfg: FluidConfig, n_steps: int,
             first: int, warm_up: bool, program: Program) -> tuple:
    """(the CUDA graph of `_record` from set `src`, in the entry's pool,
    facts for `captures`).  The key's first capture runs one eager step
    on a side stream first."""
    device = entry.sets[0].velocity.device
    with torch.cuda.device(device):
        t0 = time.perf_counter()
        if warm_up:
            current = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                program.step(entry.sets[src], cfg, entry.scene_buffers,
                             first, entry.into(src))
            current.wait_stream(side)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=entry.pool,
                              capture_error_mode=program.capture_error_mode):
            # read here: entering the capture empties PyTorch's cache
            reserved = torch.cuda.memory_reserved(device)
            residual = _record(entry, src, cfg, n_steps, first, program)
        torch.cuda.synchronize(device)
    if entry.pool is None:
        entry.pool = graph.pool()
    return graph, {"warmup_s": t1 - t0 if warm_up else 0.0,
                   "capture_s": time.perf_counter() - t1,
                   "pool_bytes": torch.cuda.memory_reserved(device)
                   - reserved, "residual": residual}


@torch.no_grad()
def replay(state: FluidState, cfg: FluidConfig, n_steps: int, scene,
           program: Program) -> FluidState:
    """n steps of `program`: on a CUDA state one replay of a CUDA graph of
    n steps, which consumes `state` where it is a state this module
    returned (module docstring); on a CPU state n eager steps."""
    if n_steps < 1:
        raise ValueError(f"n_steps = {n_steps}, expected >= 1")
    if not on_cuda(state.velocity):
        for _ in range(n_steps):
            state = program.step(state, cfg, scene, None)
        return state
    owner, src = _owner(state)
    # the phase of the volume cadence picks the entry's graph where there
    # is one
    every = cfg.volume_correction_every if cfg.volume_correction > 0.0 else 0
    first = None
    if every > 1:
        known = owner.step if owner is not None else None
        first = int(state.step) if known is None else known
    phase = first % every if every > 1 else None
    key = _key(state, cfg, n_steps, scene, program)
    entries = _GRAPHS.setdefault(key, [])
    if owner is None or owner not in entries:
        if owner is not None:
            owner.held = []        # consumed: passed in, as JAX donates
        entry = next((e for e in entries if e.free()), None)
        if entry is None:
            entry = _Entry.of(state, scene)
            entries.append(entry)
        else:
            _load(entry.sets[0], state)
        owner, src = entry, 0
    if scene is not None:
        _load(owner.scene_buffers, scene)
    traced = key[-1]                   # the key's tracing flag
    graph = owner.graphs.get((src, phase))
    if graph is None:
        with profiling.capture() as marks:
            graph, facts = _capture(owner, src, cfg, n_steps, first or 0,
                                    key not in _WARM, program)
        _WARM.add(key)
        owner.graphs[(src, phase)] = graph
        if traced:
            owner.marks[(src, phase)] = marks
        sets = owner.sets
        captures.append({"grid": tuple(cfg.grid_size), "n_steps": n_steps,
                         "phase": phase, "program": program.key,
                         "src": src, **facts,
                         "residual_bytes": sum(
                             getattr(sets[1 - src], f).nbytes
                             for f in facts["residual"])})
    if traced:
        owner.marks[(src, phase)].replay(graph)
    else:
        graph.replay()
    if every > 1:
        owner.step = first + n_steps
    out = FluidState(*(_alias(t) for t in owner.sets[1 - src]))
    owner.held = [weakref.ref(t) for t in out]
    return out


def jit_multi_step(state: FluidState, cfg: FluidConfig, n_steps: int,
                   scene=None) -> FluidState:
    """n steps: on a CUDA state one replay of a CUDA graph of n steps,
    which consumes `state` where it is a state this module returned
    (module docstring); on a CPU state n eager steps.  `scene` is an
    optional SceneFields."""
    if scene is not None:
        scene.validate(cfg)
    return replay(state, cfg, n_steps, scene, SINGLE_DEVICE)


def jit_step(state: FluidState, cfg: FluidConfig,
             scene=None) -> FluidState:
    """One step: `jit_multi_step(state, cfg, 1, scene)`."""
    return jit_multi_step(state, cfg, 1, scene)


def clear_graphs() -> None:
    """Drop every captured graph and its buffer sets (their device memory
    returns to PyTorch's allocator once no returned state holds it),
    having read the times of their last traced replays."""
    profiling.flush()
    _GRAPHS.clear()
    _WARM.clear()
