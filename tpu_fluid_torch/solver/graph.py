"""The step as a CUDA graph: `jit_step` and `jit_multi_step`, the
counterparts of `tpu_fluid/solver/step.py:jit_step` and `jit_multi_step`.

JAX compiles a step, or `lax.scan` over n steps, into one XLA program that
the host dispatches once.  The port's eager step launches a few hundred
PyTorch ops and kernels from Python, one by one.  Here the first call for
a (config, n, device, field shapes and dtypes) records n steps into one
CUDA graph, and every call replays it: one host call for n steps.

On a CUDA state, the first call for its key
  - runs one eager step on a side stream, which builds the kernels and
    fills every cache a step fills on the host (launch plans, the K6
    constant tables), and drops its result;
  - copies the state into the graph's own buffers and captures n steps
    from them under `torch.cuda.graph`, the graph ending with a copy of
    the n-th state back into those buffers;
  - replays the graph once.
Later calls replay it.

Donation, as `donate_argnums=0` in JAX: the state returned is the graph's
own buffers, and the next replay of that graph overwrites them in place.
So a state returned by one call is consumed by the next call that is given
it; clone its tensors to keep it.  A state that is not the graph's own is
copied into its buffers first and is left as it was.  The copy back at
the end of the graph reads and writes the whole state once per replay:
`jit_multi_step(state, cfg, n)` pays it once per n steps.

A scene (`core/scene_fields.SceneFields`) is a graph input like the
state: the graph reads it from buffers of its own, which every call fills
with the scene it is given, and never writes it.

Volume correction every K > 1 steps (`volume_correction_every`) runs on
the steps with `step % K == 0` only, one branch as JAX's `lax.cond`.  A
capture cannot read the step on the host, so each graph is also keyed on
the phase `step % K` of its first step and has the schedule of its n steps
unrolled into it: at most K graphs a (config, n).  The host knows the step
of a graph's own buffers (the step it loaded, plus n); it reads the step
of any other state once, before the replay.

A failed capture or replay raises; nothing falls back to the eager step on
the card.  The kernel wrappers' launch counters count the kernels they
launch at the warm-up step and in the capture, not the replays.  On a CPU
state (the caller's choice, as in the tests) both functions run the eager
step n times.
"""

from __future__ import annotations

import time

import torch

from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.core.state import FluidState
from tpu_fluid_torch.kernels import on_cuda
from tpu_fluid_torch.solver.step import simulation_step, step

# key -> (graph, buffers, scene buffers)
_GRAPHS: dict = {}
# data_ptr of a graph's step buffer -> the step its buffers hold
_OWN_STEP: dict = {}
# one record a capture: the scene's grid, n, the phase of the volume
# cadence (None without one), the warm-up step's and the capture's seconds,
# and the device memory the graph's private pool took
captures: list = []


def _fields(tensors) -> tuple:
    return tuple(None if t is None else (tuple(t.shape), t.dtype)
                 for t in tensors)


def _key(state: FluidState, cfg: FluidConfig, n_steps: int, scene,
         phase) -> tuple:
    return (cfg, n_steps, state.velocity.device, _fields(state),
            None if scene is None else _fields(scene), phase)


def _load(buffers, values) -> None:
    """Copy each tensor of `values` that is not already the buffer's
    own (None entries, a scene's absent field, are skipped)."""
    for dst, src in zip(buffers, values):
        if src is not None and src.data_ptr() != dst.data_ptr():
            dst.copy_(src)


def _capture(state: FluidState, cfg: FluidConfig, n_steps: int, scene,
             first: int, phase):
    device = state.velocity.device
    current = torch.cuda.current_stream(device)
    t0 = time.perf_counter()
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        simulation_step(state, cfg, scene, volume_step=first)
    current.wait_stream(side)
    buffers = FluidState(*(t.clone() for t in state))
    scene_buffers = None if scene is None else type(scene)(
        *(None if t is None else t.clone() for t in scene))
    torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        # read here: entering the capture empties PyTorch's cache
        reserved = torch.cuda.memory_reserved(device)
        out = buffers
        for k in range(n_steps):
            # the step number unrolls the volume cadence; no host read
            out = simulation_step(out, cfg, scene_buffers,
                                  volume_step=first + k)
        _load(buffers, out)
    torch.cuda.synchronize(device)
    captures.append({"grid": tuple(cfg.grid_size), "n_steps": n_steps,
                     "phase": phase,
                     "warmup_s": t1 - t0,
                     "capture_s": time.perf_counter() - t1,
                     "pool_bytes": torch.cuda.memory_reserved(device)
                     - reserved})
    return graph, buffers, scene_buffers


@torch.no_grad()
def jit_multi_step(state: FluidState, cfg: FluidConfig, n_steps: int,
                   scene=None) -> FluidState:
    """n steps: on a CUDA state one replay of a CUDA graph of n steps,
    which consumes the graph's own buffers (module docstring); on a CPU
    state n eager steps.  `scene` is an optional SceneFields."""
    if n_steps < 1:
        raise ValueError(f"n_steps = {n_steps}, expected >= 1")
    if scene is not None:
        scene.validate(cfg)
    if not on_cuda(state.velocity):
        for _ in range(n_steps):
            state = step(state, cfg, scene)
        return state
    # the phase of the volume cadence keys the graph where there is one
    every = cfg.volume_correction_every if cfg.volume_correction > 0.0 else 0
    first = None
    if every > 1:
        first = _OWN_STEP.get(state.step.data_ptr())
        if first is None:
            first = int(state.step)        # a state that is not a graph's
    phase = first % every if every > 1 else None
    key = _key(state, cfg, n_steps, scene, phase)
    with torch.cuda.device(state.velocity.device):
        if key not in _GRAPHS:
            _GRAPHS[key] = _capture(state, cfg, n_steps, scene, first or 0,
                                    phase)
        graph, buffers, scene_buffers = _GRAPHS[key]
        _load(buffers, state)
        if scene is not None:
            _load(scene_buffers, scene)
        graph.replay()
    if every > 1:
        _OWN_STEP[buffers.step.data_ptr()] = first + n_steps
    return buffers


def jit_step(state: FluidState, cfg: FluidConfig,
             scene=None) -> FluidState:
    """One step: `jit_multi_step(state, cfg, 1, scene)`."""
    return jit_multi_step(state, cfg, 1, scene)


def clear_graphs() -> None:
    """Drop every captured graph and its buffers (their device memory
    returns to PyTorch's allocator)."""
    _GRAPHS.clear()
    _OWN_STEP.clear()
