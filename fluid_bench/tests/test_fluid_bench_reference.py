"""The plain reference against the program's plain path on the CPU, at a
tiny scene: steps from the seeded state, field for field bitwise, on the
unfused stage path and on the fused one (the K6 groups' plain versions,
which the 256^3 configuration runs), and one small frame and its mesh."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from fluid_bench.reference import frame as ref_frame
from fluid_bench.reference import step as ref_step
from fluid_bench.state import initial


def _program_steps(cfg, state, n):
    from tpu_fluid_torch.core.state import FluidState
    from tpu_fluid_torch.solver.step import step
    s = FluidState(**state)
    out = []
    for _ in range(n):
        s = step(s, cfg)
        out.append(s._asdict())
    return out


@pytest.mark.parametrize("mode", ["off", "interpret"])
def test_steps_equal_the_program_plain_path(mode):
    from tpu_fluid_torch.core.config import FluidConfig
    from tpu_fluid_torch.kernels import fuse_grid_choice
    cfg = FluidConfig.scaled_scene(12, particle_count=20000).replace(
        pallas_mode=mode, grid_fused=True)
    assert fuse_grid_choice(cfg, "cpu") == (mode == "interpret")
    fields = dataclasses.asdict(cfg)
    state = initial(fields, 12345, "cpu")
    scene = ref_step.Scene(fields)
    ref = state
    for prog in _program_steps(cfg, state, 4):
        ref = ref_step.step(ref, scene)
        for k in ref_step.FIELDS:
            assert torch.equal(ref[k], prog[k]), k
    assert int(ref["step"]) == 4
    assert float(ref["velocity"].abs().max()) > 0


def test_frame_and_mesh_equal_the_program():
    from tpu_fluid_torch.core.config import FluidConfig
    from tpu_fluid_torch.core.state import FluidState
    from tpu_fluid_torch.engine import Simulation
    from tpu_fluid_torch.solver.step import step
    cfg = FluidConfig.scaled_scene(12, particle_count=20000)
    fields = dataclasses.asdict(cfg)
    s = FluidState(**initial(fields, 7, "cpu"))
    for _ in range(5):
        s = step(s, cfg)
    sim = Simulation(cfg, state=s, device="cpu")
    img = sim.render_frame(80, 64).numpy()
    mesh = sim.surface_mesh()
    rimg, (verts, normals, valid) = ref_frame.frame(s._asdict(), fields, 80,
                                                    64)
    assert img.shape == (64, 80, 3)
    assert np.array_equal(img, rimg.numpy())
    assert int(mesh.count) > 0
    assert torch.equal(mesh.valid, valid)
    assert torch.equal(mesh.vertices[valid], verts[valid])
    assert torch.equal(mesh.normals[valid], normals[valid])
    assert np.array_equal(ref_frame.camera_mvp(cfg.grid_size),
                          sim.camera.mvp())


def test_the_reference_refuses_options_it_does_not_implement():
    from tpu_fluid_torch.core.config import FluidConfig
    fields = dataclasses.asdict(FluidConfig.reference_scene())
    for key, value in (("volume_correction", 1.0),
                       ("surface_method", "levelset"),
                       ("pressure_solver", "redblack"),
                       ("advect_method", "gather")):
        with pytest.raises(ValueError):
            ref_step.Scene(dict(fields, **{key: value}))


def test_seeded_state_keeps_the_source_cube():
    from tpu_fluid_torch.core.config import FluidConfig
    cfg = FluidConfig.scaled_scene(12, particle_count=20000)
    fields = dataclasses.asdict(cfg)
    a = initial(fields, 2 ** 31 + 11, "cpu")
    b = initial(fields, 2 ** 31 + 11, "cpu")
    c = initial(fields, 2 ** 31 + 12, "cpu")
    assert torch.equal(a["positions"], b["positions"])
    assert not torch.equal(a["positions"], c["positions"])
    # every particle inside its own lattice cell of the cube
    res = torch.tensor(cfg.particle_init_cube_resolution, dtype=torch.float32)
    off = torch.tensor(cfg.particle_init_cube_offset)
    size = torch.tensor(cfg.particle_init_cube_size)
    ids = torch.arange(cfg.particle_count)
    rx, ry, _ = cfg.particle_init_cube_resolution
    idx = torch.stack([ids % rx, (ids // rx) % ry, ids // (rx * ry)],
                      -1).float()
    cell = (a["positions"] - off) / size * res - idx
    active = a["active"]
    assert bool(((cell[active] >= -1e-4) & (cell[active] < 1 + 1e-4)).all())
    assert int(active.sum()) == min(cfg.particle_count, int(res.prod()))
