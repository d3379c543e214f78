"""The benchmark's plain reference of the level-set step
(`fluid_bench/reference/step_levelset.py`) against the port's eager step
with `surface_method="levelset"`, on the CPU at a small scene with a
solid pillar: every field bitwise for three steps, with each smoothing
count and with the iso and sweeps derived and set, on the unfused and the
fused stage path; the reference in bfloat16 (the benchmark's control)
fails the judge's float limit; and each reference refuses, by name, the
options it does not implement."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from fluid_bench import check
from fluid_bench.reference import step as ref_step
from fluid_bench.reference import step_levelset as ref_ls
from fluid_bench.state import initial
from tpu_fluid_torch import FluidConfig
from tpu_fluid_torch.core.state import FluidState
from tpu_fluid_torch.solver.step import step

torch.set_num_threads(2)

SEED = 2 ** 31 + 27
STEPS = 3
# the fountain at 20^3 with detail 2, and a pillar under the falling cube
CFG = FluidConfig.scaled_scene(20, particle_count=20000,
                               jacobi_iters=40).replace(
    surface_method="levelset", solid_boxes=(((8, 11, 1), (11, 19, 5)),))
CASES = {
    "smooth0": dict(levelset_smooth=0),
    "smooth1": dict(levelset_smooth=1),
    "smooth2": dict(levelset_smooth=2),
    "set_iso_and_sweeps": dict(levelset_iso=1.7, levelset_sweeps=3),
    "fused": dict(pallas_mode="interpret", grid_fused=True),
}


def _fields(cfg: FluidConfig) -> dict:
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_reference_steps_as_the_program(case):
    cfg = CFG.replace(**CASES[case])
    fields = _fields(cfg)
    scene = ref_ls.Scene(fields)
    assert scene.levelset_iso_value == cfg.levelset_iso_value
    assert scene.levelset_sweeps_value == cfg.levelset_sweeps_value
    start = initial(fields, SEED, "cpu")
    prog, ref = FluidState(**start), start
    for _ in range(STEPS):
        prog = step(prog, cfg)
        ref = ref_ls.step(ref, scene)
        for k in ref_ls.FIELDS:
            a, b = getattr(prog, k), ref[k]
            assert a.dtype == b.dtype and torch.equal(a, b), k
    # the field holds an inside, an outside and the pillar's kept cells
    f = ref["float_dens_1"]
    assert float(f.max()) > 0 > float(f.min())
    assert torch.equal(ref["inertia"], start["inertia"])
    assert int(ref["step"]) == STEPS


def test_the_derived_iso_and_sweeps_are_the_configurations():
    for n, count in ((20, 20000), (256, 2_000_000)):
        cfg = FluidConfig.scaled_scene(n, particle_count=count).replace(
            surface_method="levelset")
        scene = ref_ls.Scene(_fields(cfg))
        assert scene.target_density == cfg.volume_target_density_value
        assert scene.levelset_iso_value == cfg.levelset_iso_value
        assert scene.levelset_sweeps_value == cfg.levelset_sweeps_value


def test_the_control_in_bfloat16_fails_the_float_limit():
    fields = _fields(CFG)
    scene = ref_ls.Scene(fields)
    s = initial(fields, SEED, "cpu")
    for _ in range(2):
        s = ref_ls.step(s, scene)
    want = ref_ls.step(s, scene)
    got = {k: (v.float() if k in ref_ls.FLOAT_FIELDS else v)
           for k, v in ref_ls.step(s, scene, dtype=torch.bfloat16).items()}
    gap, _ = check.state_numbers(got, want, ref_ls)
    assert gap > check.LIMITS["state_gap"]
    only_field = dict(want, float_dens_1=got["float_dens_1"],
                      float_dens_2=got["float_dens_2"])
    gap, _ = check.state_numbers(only_field, want, ref_ls)
    assert gap > check.LIMITS["state_gap"]


@pytest.mark.parametrize("key,value", [("surface_method", "inertia"),
                                       ("pressure_solver", "redblack"),
                                       ("volume_correction", 1.0),
                                       ("particle_sharding", "domain")])
def test_the_levelset_reference_refuses_other_options(key, value):
    with pytest.raises(ValueError, match=key):
        ref_ls.Scene(dict(_fields(CFG), **{key: value}))


def test_the_default_reference_still_refuses_the_levelset():
    with pytest.raises(ValueError, match="surface_method"):
        ref_step.Scene(_fields(CFG))
