"""The step as a CUDA graph: `jit_step` and `jit_multi_step`, the
counterparts of `tpu_fluid/solver/step.py:jit_step` and `jit_multi_step`.

JAX compiles a step, or `lax.scan` over n steps, into one XLA program that
the host dispatches once.  The port's eager step launches a few hundred
PyTorch ops and kernels from Python, one by one.  Here a call for a
(config, n, device, field shapes and dtypes) replays a CUDA graph of n
steps: one host call for n steps.

Each such key holds a few entries: a graph, the buffers it steps (its own
state and scene) and the step those buffers hold.  A call on a CUDA state

  - replays the entry whose buffers the state is (every field's
    `data_ptr`), as `jit_step(jit_step(s))` does on one lineage;
  - else takes a free entry of the key and copies the state into its
    buffers, or captures a new entry: fresh buffers cloned from the state,
    n steps recorded from them under `torch.cuda.graph`, the graph ending
    with a copy of the n-th state back into those buffers.  The first
    capture of a key runs one eager step on a side stream first, which
    builds the kernels and fills every cache a step fills on the host
    (launch plans, the K6 constant tables), and drops its result.

Donation, as `donate_argnums=0` in JAX: a state that a call returns stays
valid until that same state is passed back in; a call given any other
state never writes it.  The returned tensors are new tensor objects over
the entry's buffers, and the entry keeps weak references to them.  An
entry is free once none of them is held (a view taken of one holds it), or
once the state it returned was passed to a call, which consumes it.  So
two live states of one key (two `Simulation`s, or one beside a loaded
checkpoint) step in entries of their own, and a dropped lineage's entry is
reused rather than captured again.  A state that is no entry's buffers is
copied in and left as it was.  The copy back at the end of the graph reads
and writes the whole state once per replay: `jit_multi_step(state, cfg,
n)` pays it once per n steps.

A scene (`core/scene_fields.SceneFields`) is a graph input like the
state: the graph reads it from buffers of its own, which every call fills
with the scene it is given, and never writes it.

Volume correction every K > 1 steps (`volume_correction_every`) runs on
the steps with `step % K == 0` only, one branch as JAX's `lax.cond`.  A
capture cannot read the step on the host, so each graph is also keyed on
the phase `step % K` of its first step and has the schedule of its n steps
unrolled into it: at most K keys a (config, n).  Each entry knows the step
of its buffers (the step it loaded, plus n); the host reads the step of
any other state once, before the replay.

The step a graph records is its `Program`: the single-device
`simulation_step`, or one shard's step of the x-slab layout bound to its
mesh (`parallel/spmd_step.jit_spmd_step`, `jit_spmd_multi_step`, JAX's
jitted `spmd_step` and `spmd_multi_step`).  The program's key (the
mesh's rank, size, backend and device) is part of the graph key; every
rule above holds for both.  On an nccl mesh the collectives are captured
too: the warm-up step creates the communicators, and every rank captures
the same sequence of collectives, since each takes the same branches.

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


@dataclasses.dataclass(frozen=True)
class Program:
    """The step a graph records: `step(state, cfg, scene, volume_step)`
    returns the next state, reading `state.step` on the host only where
    `volume_step` is None; `key` tells its graphs apart from other
    programs' (None for the single-device step); `capture_error_mode` is
    passed to `torch.cuda.graph`."""
    step: Callable
    key: tuple | None = None
    capture_error_mode: str = "global"


SINGLE_DEVICE = Program(simulation_step)


@dataclasses.dataclass(eq=False)
class _Entry:
    """A captured graph and the buffers it steps."""
    graph: torch.cuda.CUDAGraph
    buffers: FluidState
    scene_buffers: object = None
    step: int | None = None       # the step its buffers hold (cadence)
    held: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.ptrs = _ptrs(self.buffers)

    def free(self) -> bool:
        """No state this entry returned is still held, or it was passed
        to a call."""
        return all(ref() is None for ref in self.held)


# key -> [_Entry]
_GRAPHS: dict = {}
# keys whose eager warm-up step has run
_WARM: set = set()
# one record a capture: the scene's grid, n, the phase of the volume
# cadence (None without one), the warm-up step's seconds (0.0 after the
# key's first capture) and the capture's, and the device memory the graph's
# private pool took
captures: list = []


def _fields(tensors) -> tuple:
    return tuple(None if t is None else (tuple(t.shape), t.dtype)
                 for t in tensors)


def _ptrs(state) -> tuple:
    return tuple(t.data_ptr() for t in state)


def _key(state: FluidState, cfg: FluidConfig, n_steps: int, scene,
         phase, program: Program) -> tuple:
    return (program.key, cfg, n_steps, state.velocity.device,
            _fields(state), None if scene is None else _fields(scene), phase)


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


def _owner(state: FluidState):
    """The entry whose buffers `state` is, of any key, else None."""
    ptrs = _ptrs(state)
    for entries in _GRAPHS.values():
        for entry in entries:
            if entry.ptrs == ptrs:
                return entry
    return None


def _capture(state: FluidState, cfg: FluidConfig, n_steps: int, scene,
             first: int, phase, warm_up: bool, program: Program) -> _Entry:
    device = state.velocity.device
    with torch.cuda.device(device):
        t0 = time.perf_counter()
        if warm_up:
            current = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                program.step(state, cfg, scene, first)
            current.wait_stream(side)
        buffers = FluidState(*(t.clone() for t in state))
        scene_buffers = None if scene is None else type(scene)(
            *(None if t is None else t.clone() for t in scene))
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph,
                              capture_error_mode=program.capture_error_mode):
            # read here: entering the capture empties PyTorch's cache
            reserved = torch.cuda.memory_reserved(device)
            out = buffers
            for k in range(n_steps):
                # the step number unrolls the volume cadence; no host read
                out = program.step(out, cfg, scene_buffers, first + k)
            _load(buffers, out)
        torch.cuda.synchronize(device)
    captures.append({"grid": tuple(cfg.grid_size), "n_steps": n_steps,
                     "phase": phase, "program": program.key,
                     "warmup_s": t1 - t0 if warm_up else 0.0,
                     "capture_s": time.perf_counter() - t1,
                     "pool_bytes": torch.cuda.memory_reserved(device)
                     - reserved})
    return _Entry(graph, buffers, scene_buffers)


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
    owner = _owner(state)
    # the phase of the volume cadence keys the graph where there is one
    every = cfg.volume_correction_every if cfg.volume_correction > 0.0 else 0
    first = None
    if every > 1:
        known = owner.step if owner is not None else None
        first = int(state.step) if known is None else known
    phase = first % every if every > 1 else None
    key = _key(state, cfg, n_steps, scene, phase, program)
    entries = _GRAPHS.setdefault(key, [])
    if owner is not None and owner in entries:
        entry = owner
    else:
        if owner is not None:
            owner.held = []        # consumed: passed in, as JAX donates
        entry = next((e for e in entries if e.free()), None)
        if entry is None:
            entry = _capture(state, cfg, n_steps, scene, first or 0, phase,
                             key not in _WARM, program)
            _WARM.add(key)
            entries.append(entry)
        _load(entry.buffers, state)
    if scene is not None:
        _load(entry.scene_buffers, scene)
    entry.graph.replay()
    if every > 1:
        entry.step = first + n_steps
    out = FluidState(*(_alias(t) for t in entry.buffers))
    entry.held = [weakref.ref(t) for t in out]
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
    """Drop every captured graph and its buffers (their device memory
    returns to PyTorch's allocator once no returned state holds it)."""
    _GRAPHS.clear()
    _WARM.clear()
