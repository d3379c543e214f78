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

Beyond the reference, as in the JAX package: volume correction
(`volume_correction`), the level-set surface (`surface_method="levelset"`),
the red-black solver (`pressure_solver="redblack"`), scene presets
(`SCENES`) and scene fields passed beside the state:

    from tpu_fluid_torch import SceneFields, dam_break_obstacle, solid_sphere
    cfg = dam_break_obstacle(64)
    scene = SceneFields(solid=solid_sphere(cfg, (32, 48, 32), 6))
    state = jit_step(initial_state(cfg), cfg, scene)

The engine and the CLI, as in the JAX package: `Simulation(cfg)` steps,
meshes, renders, checkpoints and runs the headless loop on the card
(`device="cpu"` else), and `python -m tpu_fluid_torch.cli` (the
`tpu-fluid-torch` script) drives it:

    sim = Simulation(FluidConfig.scaled_scene(64)).step(10)
    sim.save("out/checkpoint.npz")
    img = sim.render_frame(512, 512)      # (H, W, 3) uint8 on the card
    sim = Simulation.load("out/checkpoint.npz")
"""

from tpu_fluid_torch.core import scenes
from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.core.scene_fields import (SceneFields, solid_sphere,
                                               uniform_force, vortex_force)
from tpu_fluid_torch.core.scenes import (SCENES, dam_break,
                                         dam_break_obstacle, drop, fountain)
from tpu_fluid_torch.core.state import FluidState, initial_state
from tpu_fluid_torch.core.types import CellType
from tpu_fluid_torch.engine import Simulation
from tpu_fluid_torch.solver.graph import jit_multi_step, jit_step
from tpu_fluid_torch.solver.step import simulation_step, step

__all__ = [
    "FluidConfig",
    "FluidState",
    "CellType",
    "SCENES",
    "SceneFields",
    "Simulation",
    "dam_break",
    "dam_break_obstacle",
    "drop",
    "fountain",
    "initial_state",
    "jit_multi_step",
    "jit_step",
    "scenes",
    "simulation_step",
    "solid_sphere",
    "step",
    "uniform_force",
    "vortex_force",
]
__version__ = "0.1.0"
