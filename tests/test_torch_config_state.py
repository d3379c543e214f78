"""The PyTorch port's configuration, state and kernel gate against the JAX
package: same config fields and defaults, the same initial state, and a
state that crosses between the two packages through numpy."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_fluid.core.config import FluidConfig as JaxConfig
from tpu_fluid.core.state import initial_state as jax_initial_state
from tpu_fluid.core.types import CellType as JaxCellType
from tpu_fluid_torch import CellType, FluidConfig, initial_state
from tpu_fluid_torch.core.config import deep_tuple
from tpu_fluid_torch.core.state import state_from_numpy, state_to_numpy
from tpu_fluid_torch.kernels import fuse_grid_choice, kernel_choice

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent

SMALL = dict(grid_size=(10, 12, 8), particle_count=700,
             particle_init_cube_resolution=(9, 8, 7),
             particle_init_cube_offset=(2.0, 1.5, 1.25),
             particle_init_cube_size=(5.0, 6.0, 4.5),
             surface_render_resolution=2)
MULTI = dict(SMALL, particle_count=900,
             extra_particle_cubes=(((4, 4, 4), (6.0, 7.0, 3.0),
                                    (2.0, 2.0, 2.0)),))


def test_config_fields_and_defaults_match_jax():
    jf = {f.name: f for f in dataclasses.fields(JaxConfig)}
    tf = {f.name: f for f in dataclasses.fields(FluidConfig)}
    assert list(jf) == list(tf)
    for name, f in jf.items():
        assert tf[name].default == f.default, name
        assert tf[name].default_factory == f.default_factory, name


@pytest.mark.parametrize("factory", [
    lambda m: m.reference_scene(),
    lambda m: m.scaled_scene(16, particle_count=1000, jacobi_iters=2),
    lambda m: m.scaled_scene(256),
    lambda m: m(**MULTI).replace(max_inertia=300, fountain_position=(1, 2, 3),
                                 levelset_iso=1.5),
])
def test_config_factories_and_properties_match_jax(factory):
    j, t = factory(JaxConfig), factory(FluidConfig)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for prop in ("fountain", "detailed_size", "surface_cells",
                 "volume_target_density_value", "levelset_iso_value",
                 "levelset_sweeps_value"):
        assert getattr(j, prop) == getattr(t, prop), prop
    assert t.torch_dtype == torch.float32
    want = torch.uint8 if j.inertia_dtype == jnp.uint8 else torch.int32
    assert t.inertia_dtype == want


def test_config_json_interchange():
    """A JAX config's JSON form (lists for tuples) builds the same port
    config and back."""
    j = JaxConfig(**MULTI).replace(solid_boxes=(((1, 1, 1), (3, 3, 3)),),
                                   extra_forces=(((2, 2, 2), (0, -5.0, 0)),))
    data = json.loads(json.dumps(dataclasses.asdict(j)))
    t = FluidConfig(**{k: deep_tuple(v) for k, v in data.items()})
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert JaxConfig(**dataclasses.asdict(t)) == j
    hash(t)


def test_cell_type_codes_match_jax():
    for name in ("INACTIVE", "AIR", "WATER", "SOLID"):
        assert getattr(CellType, name) == getattr(JaxCellType, name)


def _assert_state_matches(port, jax_state):
    got = state_to_numpy(port)
    for name, value in jax_state._asdict().items():
        want = np.asarray(value)
        assert got[name].dtype == want.dtype, name
        assert got[name].shape == want.shape, name
        if name == "positions":
            # XLA:CPU may contract off + (idx / res) * size into one FMA;
            # the port rounds the product and the sum separately (1 ULP)
            np.testing.assert_array_max_ulp(got[name], want, maxulp=1)
        else:
            np.testing.assert_array_equal(got[name], want, err_msg=name)


@pytest.mark.parametrize("kw", [SMALL, MULTI,
                                dict(SMALL, max_inertia=300)])
def test_initial_state_matches_jax(kw):
    _assert_state_matches(initial_state(FluidConfig(**kw), device="cpu"),
                          jax_initial_state(JaxConfig(**kw)))


def test_initial_state_reference_cube_prefix():
    """The reference scene's spawn math on a prefix of its ids: the id
    arithmetic (int64 here, uint32 in JAX) places the same particles."""
    kw = dict(particle_count=20_000, surface_render_resolution=1)
    _assert_state_matches(initial_state(FluidConfig(**kw), device="cpu"),
                          jax_initial_state(JaxConfig(**kw)))


def test_state_numpy_round_trip_from_jax():
    jax_state = jax_initial_state(JaxConfig(**SMALL))
    arrays = {k: np.asarray(v) for k, v in jax_state._asdict().items()}
    port = state_from_numpy(arrays, device="cpu")
    assert port.positions.is_contiguous() and port.active.dtype == torch.bool
    back = state_to_numpy(port)
    for name, value in arrays.items():
        np.testing.assert_array_equal(back[name], value, err_msg=name)


def test_import_keeps_jax_out():
    code = ("import sys, tpu_fluid_torch, tpu_fluid_torch.solver.step, "
            "tpu_fluid_torch.kernels.build; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'tpu_fluid.'))] + "
            "[m for m in sys.modules if m == 'tpu_fluid']; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_kernel_choice_gate():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    cfg = FluidConfig()
    assert kernel_choice(cfg, cpu) is False
    assert kernel_choice(cfg, cuda) is True
    for mode in ("off", "interpret"):
        assert kernel_choice(cfg.replace(pallas_mode=mode), cuda) is False
    assert kernel_choice(cfg.replace(pallas_mode="on"), cuda) is True
    with pytest.raises(RuntimeError):
        kernel_choice(cfg.replace(pallas_mode="on"), cpu)
    with pytest.raises(ValueError):
        kernel_choice(cfg.replace(pallas_mode="sometimes"), cpu)


def test_fuse_grid_gate_raises_where_jax_would_fuse():
    """The fused grid gate never raises now that K6 is ported: for every
    case of tests/test_grid_fused.py:120-139 and every pallas mode it
    answers as JAX's `fuse_grid_choice` does ("auto" on CUDA tensors where
    JAX asks for a TPU), except that the CUDA kernels ("on" and "auto" on
    CUDA tensors) take planes above JAX's VMEM limit."""
    from tpu_fluid.kernels import fuse_grid_choice as jax_fuse_grid_choice

    class Scene:
        solid = force = None

    on = dict(grid_size=(24, 16, 12), grid_fused=True)
    cases = [(on, None), (dict(on, grid_fused=False), None),
             (dict(on, reference_diffuse_noop=False), None),
             (on, Scene()), (dict(on, grid_size=(8, 256, 384)), None),
             (dict(on, grid_size=(8, 256, 512)), None),
             (dataclasses.asdict(FluidConfig.scaled_scene(256)), None),
             (dataclasses.asdict(FluidConfig.scaled_scene(128)), None)]
    answers = []
    for kw, scene in cases:
        for mode in ("on", "interpret", "off"):
            jcfg = JaxConfig(**dict(kw, pallas_mode=mode))
            cfg = FluidConfig(**dict(kw, pallas_mode=mode))
            want = jax_fuse_grid_choice(jcfg, scene)
            gate = (cfg.grid_fused and cfg.reference_diffuse_noop
                    and scene is None)
            small = cfg.grid_size[1] * cfg.grid_size[2] <= 98304
            for device in ("cpu", "cuda"):
                card = device == "cuda" and mode == "on"
                expect = gate if card else want
                if small:
                    assert expect is want
                assert fuse_grid_choice(cfg, torch.device(device),
                                        scene) is expect, (kw, mode, device)
            answers.append(want)
        auto = FluidConfig(**dict(kw, pallas_mode="auto"))
        on = FluidConfig(**dict(kw, pallas_mode="on"))
        assert fuse_grid_choice(auto, torch.device("cpu"), scene) is False
        assert (fuse_grid_choice(auto, torch.device("cuda"), scene)
                is fuse_grid_choice(on, torch.device("cuda"), scene))
    assert True in answers and False in answers
    assert fuse_grid_choice(FluidConfig.scaled_scene(256),
                            torch.device("cuda"))


@pytest.mark.parametrize("n", [512, 768])
def test_fuse_grid_gate_has_no_plane_limit_on_the_card(n):
    """Above JAX's plane limit (y*z > 98,304) the CUDA K6 kernels still run
    on the card, single-device and domain-sharded alike, while the plain
    versions, which stand in for JAX's route, keep JAX's answer."""
    from tpu_fluid.kernels import fuse_grid_choice as jax_fuse_grid_choice
    cfg = FluidConfig.scaled_scene(n, particle_count=20000)
    jcfg = JaxConfig(**dataclasses.asdict(cfg.replace(
        pallas_mode="interpret")))
    assert not jax_fuse_grid_choice(jcfg)
    for c in (cfg, cfg.replace(particle_sharding="domain")):
        assert fuse_grid_choice(c, torch.device("cuda"))
        assert fuse_grid_choice(c.replace(pallas_mode="on"),
                                torch.device("cuda"))
        assert not fuse_grid_choice(c, torch.device("cpu"))
        for device in ("cpu", "cuda"):
            assert not fuse_grid_choice(c.replace(pallas_mode="interpret"),
                                        torch.device(device))
