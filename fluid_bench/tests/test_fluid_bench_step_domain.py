"""The sharded plain reference of domain-sharded particles
(`fluid_bench/reference/step_domain.py`) on 2 and 4 gloo ranks: its slabs
put together equal `reference/step.py`'s single-device step bitwise, its
particles equal them as a set and nothing is dropped; the program's x-slab
step (`parallel.spmd_step`, its plain route, unfused and fused) equals it
part by part, slot for slot; and its `Scene` refuses every option it does
not implement, by name."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from fluid_bench.reference import step as ref_step
from fluid_bench.reference import step_domain
from fluid_bench.state import initial, slab

SEED = 2 ** 31 + 977
STEPS = 3
TIMEOUT = 300.0
GRID = ("velocity", "cell_types", "inertia", "float_dens_1", "float_dens_2",
        "detailed_occ")


def _fields(**kw) -> dict:
    from tpu_fluid_torch.core.config import FluidConfig
    base = kw.pop("base")
    cfg = base.replace(particle_sharding="domain", **kw)
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def cases() -> dict:
    """Scenes by name: the fountain at 24^3, and a 32 x 16 x 16 scene whose
    force cells beside the slab borders of 2 and 4 ranks push particles
    across them, so that the migration moves some."""
    from tpu_fluid_torch.core.config import FluidConfig
    fountain = FluidConfig.scaled_scene(24, particle_count=20000)
    crossing = FluidConfig(
        grid_size=(32, 16, 16), particle_count=4096,
        particle_init_cube_resolution=(16, 16, 16),
        particle_init_cube_offset=(5.0, 2.0, 2.0),
        particle_init_cube_size=(20.0, 9.0, 5.0),
        surface_render_resolution=2, jacobi_iters=40,
        advect_max_displacement=1, fountain_force=-2000.0,
        fountain_position=(16, 14, 8),
        extra_forces=tuple(((x, 6, 4), (20000.0, 0.0, 0.0))
                           for x in (7, 15, 23)))
    return {
        "fountain": _fields(base=fountain),
        "crossing": _fields(base=crossing),
        # the program's fused grid groups (K6's plain halo forms)
        "crossing_fused": _fields(base=crossing, pallas_mode="interpret",
                                  grid_fused=True),
        # a solid box across the middle slab border, and the diffusion
        "crossing_box": _fields(base=crossing, reference_diffuse_noop=False,
                                solid_boxes=(((14, 3, 3), (18, 6, 7)),)),
    }


def _numpy(state: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


def _rank(rank, n, init_method, names, steps):
    """Each case's reference chain from the rank's part, and whether the
    program's step from each of its states equals the reference's, field
    by field and slot by slot."""
    from fluid_bench.loop import as_state, program_config
    from tpu_fluid_torch.parallel.mesh import make_mesh
    from tpu_fluid_torch.parallel.spmd_step import spmd_step
    torch.set_num_threads(1)
    mesh = make_mesh(n, rank, init_method, device="cpu", backend="gloo")
    out = {}
    for name in names:
        fields = cases()[name]
        scene = step_domain.Scene(fields)
        program = spmd_step(program_config(fields), mesh)
        s = step_domain.part(initial(fields, SEED, "cpu",
                                     x_range=slab(fields, rank, n)),
                             scene, mesh.group)
        chain, equal = [_numpy(s)], []
        moved = 0
        for _ in range(steps):
            got = program(as_state(dict(s)))._asdict()
            nxt = step_domain.step(s, scene, group=mesh.group)
            equal.append([k for k in ref_step.FIELDS
                          if not torch.equal(got[k], nxt[k])])
            moved += int((nxt["active"] != s["active"]).sum())
            s = nxt
            chain.append(_numpy(s))
        out[name] = {"chain": chain, "unequal": equal, "moved": moved}
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def ranks(request):
    from tpu_fluid_torch.parallel.launch import run_ranks
    n = request.param
    return n, run_ranks(_rank, n, sorted(cases()), STEPS, timeout=TIMEOUT)


def _sorted(pos, act):
    p = pos[act]
    return p[np.lexsort((p[:, 2], p[:, 1], p[:, 0]))]


@pytest.mark.parametrize("name", sorted(cases()))
def test_slabs_equal_the_single_device_reference(ranks, name):
    """The slabs put together equal `reference/step.py`'s step bitwise at
    every step; the active particles equal its as a set; none dropped."""
    n, out = ranks
    fields = cases()[name]
    scene = ref_step.Scene(dict(fields, particle_sharding="index"))
    whole = initial(fields, SEED, "cpu")
    for k in range(STEPS + 1):
        parts = [out[r][name]["chain"][k] for r in range(n)]
        for f in GRID:
            got = np.concatenate([p[f] for p in parts],
                                 axis=1 if f == "velocity" else 0)
            want = whole[f].numpy()
            assert got.dtype == want.dtype and np.array_equal(got, want), \
                (name, k, f)
        pos = np.concatenate([p["positions"] for p in parts])
        act = np.concatenate([p["active"] for p in parts])
        want_pos = whole["positions"].numpy()
        want_act = whole["active"].numpy()
        assert np.array_equal(_sorted(pos, act), _sorted(want_pos, want_act))
        for p in parts:
            assert int(p["step"]) == k and int(p["dropped"]) == 0
        if k < STEPS:
            whole = ref_step.step(whole, scene)


def test_the_crossing_scene_migrates(ranks):
    """Particles change ranks in the crossing scene, so the placement rule
    is held against the program's."""
    n, out = ranks
    assert sum(out[r]["crossing"]["moved"] for r in range(n)) > 0


@pytest.mark.parametrize("name", sorted(cases()))
def test_the_programs_step_equals_it_slot_for_slot(ranks, name):
    """The program's x-slab step, from each of the reference's states,
    equals the reference's next state on every rank, field by field and
    slot by slot."""
    n, out = ranks
    for r in range(n):
        assert out[r][name]["unequal"] == [[]] * STEPS, (r, name)


# option: (a value the reference does not implement, what its refusal names)
REFUSED = {
    "volume_correction": (1.0, "volume_correction"),
    "surface_method": ("levelset", "surface_method"),
    "pressure_solver": ("redblack", "pressure_solver"),
    "particle_sampler": ("gather", "particle_sampler"),
    "surface_enabled": (False, "surface_enabled"),
    "dtype": ("float64", "dtype"),
    "particle_sharding": ("index", "particle_sharding"),
    "advect_method": ("gather", "advection"),
}


@pytest.mark.parametrize("key", sorted(REFUSED))
def test_the_scene_refuses_what_it_does_not_implement(key):
    fields = cases()["fountain"]
    step_domain.Scene(fields)
    value, named = REFUSED[key]
    with pytest.raises(ValueError, match=named):
        step_domain.Scene(dict(fields, **{key: value}))


def test_part_is_the_programs_layout(monkeypatch):
    """`part` of the slab seed is `domain_shard_state` of the whole seed
    on every rank of 2 and 4, field by field and bitwise."""
    from fluid_bench.loop import as_state, program_config
    from tpu_fluid_torch.parallel.particles_domain import domain_shard_state
    fields = cases()["fountain"]
    scene = step_domain.Scene(fields)
    cfg = program_config(fields)
    whole = as_state(initial(fields, SEED, "cpu"))
    for n in (2, 4):
        for r in range(n):
            monkeypatch.setattr(step_domain, "_where",
                                lambda group, r=r, n=n: (r, n))
            got = step_domain.part(initial(
                fields, SEED, "cpu", x_range=slab(fields, r, n)), scene,
                "group")
            want = domain_shard_state(whole, r, n, cfg)._asdict()
            for k, v in want.items():
                assert got[k].dtype == v.dtype and torch.equal(got[k], v), \
                    (n, r, k)
