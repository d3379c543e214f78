"""tpu_fluid_torch — the MAC-grid + marker-particle fluid simulation of
`tpu_fluid`, ported to PyTorch, with hand-written CUDA kernels for NVIDIA
Hopper on its hot stages.

Quick start:

    from tpu_fluid_torch import FluidConfig, initial_state, jit_step
    cfg = FluidConfig.reference_scene()
    state = initial_state(cfg)        # on the card; device="cpu" else
    for _ in range(100):
        state = jit_step(state, cfg)  # a CUDA-graph replay; `step` is eager

`jit_step` and `jit_multi_step` (solver/graph.py) consume the state they
are given, as JAX's donating `jit_step` does: keep a clone to hold one.
"""

from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.core.state import FluidState, initial_state
from tpu_fluid_torch.core.types import CellType
from tpu_fluid_torch.solver.graph import jit_multi_step, jit_step
from tpu_fluid_torch.solver.step import simulation_step, step

__all__ = [
    "FluidConfig",
    "FluidState",
    "CellType",
    "initial_state",
    "jit_multi_step",
    "jit_step",
    "simulation_step",
    "step",
]
__version__ = "0.1.0"
