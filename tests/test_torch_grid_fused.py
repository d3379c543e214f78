"""K6, the fused sim-grid stage groups: each plain PyTorch version against
the JAX package's Pallas kernel in the Pallas interpreter, at the grid of
tests/test_grid_fused.py, with and without solid boxes and extra forces;
K6a's pooled plain version (stage 01 taken in) against JAX's
`occupancy_to_sim_grid` followed by its kernel, at pools 1-3; the
wrappers' checks; K6c's halo form over 4 slabs, with NaN in the halo
planes it does not read, against its single-device form.  The wrappers'
CPU routing and the CUDA kernels against their plain versions are cases
of tests/test_torch_kernels.py.

Cell types must be equal.  f32 results must agree within 1 ULP of the
field's scale: XLA:CPU may contract a*b+c into one fused multiply-add
inside the interpreted kernel, where the plain version rounds twice (the
allowance of commit 5687bef).  The largest differences seen on these
inputs: 0 for K6a (types and velocity); 6.0e-8 for K6b's velocity and
9.5e-7 for its divergence (scale 31); 4.8e-7 for K6c (scale 11)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_fluid.core.config import FluidConfig as JaxConfig
from tpu_fluid.kernels.grid_fused import (classify_extrap_pallas,
                                          forces_solids_div_pallas,
                                          project_pallas)
from tpu_fluid.stages.particles import occupancy_to_sim_grid
from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.kernels.grid_fused import (classify_extrap_cuda,
                                                classify_extrap_plain,
                                                forces_solids_div_cuda,
                                                forces_solids_div_plain,
                                                project_cuda,
                                                project_halo_cuda,
                                                project_halo_plain,
                                                project_plain)

torch.set_num_threads(2)
EPS = np.finfo(np.float32).eps
GRID = (24, 16, 12)
BOXES = [(), (((4, 3, 2), (9, 8, 6)),)]
FORCES = [(), (((5, 4, 3), (100.0, 0.0, -50.0)),
               ((11, 7, 6), (0.0, -30.0, 0.0)))]


def configs(**kw):
    """The same config in both packages."""
    kw = dict(grid_size=GRID, **kw)
    return JaxConfig(**kw), FluidConfig(**kw)


def T(a):
    return torch.from_numpy(np.array(a))


def same(got, want, ulp=0):
    g, w = got.numpy(), np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype
    if ulp == 0:
        np.testing.assert_array_equal(g, w)
    else:
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=ulp * EPS,
                                   atol=ulp * EPS * scale)


def fields(seed):
    """Occupancy, old types, velocity and pressure from a numpy seed; the
    types carry the solid border as the step's types do."""
    r = np.random.default_rng(seed)
    occ = (r.random(GRID) < 0.35).astype(np.uint8)
    types = r.integers(0, 3, GRID).astype(np.uint8)
    types[0], types[-1], types[:, 0], types[:, -1] = (3,) * 4
    types[:, :, 0], types[:, :, -1] = 3, 3
    vel = (3.0 * r.standard_normal((3,) + GRID)).astype(np.float32)
    p = r.standard_normal(GRID).astype(np.float32)
    return occ, types, vel, p


@pytest.mark.parametrize("boxes", BOXES)
def test_classify_extrap_plain_matches_pallas_interpret(boxes):
    jcfg, cfg = configs(solid_boxes=boxes)
    occ, old, vel, _ = fields(0)
    # old types with every code, as a step that changes classification
    old = np.random.default_rng(1).integers(0, 4, GRID).astype(np.uint8)
    want_t, want_v = classify_extrap_pallas(
        jnp.asarray(occ), jnp.asarray(old), jnp.asarray(vel), jcfg,
        interpret=True)
    got_t, got_v = classify_extrap_plain(T(occ), T(old), T(vel), cfg)
    same(got_t, want_t)
    same(got_v, want_v, ulp=1)


def sparse_occupancy(r, shape, pool):
    """Detailed occupancy at `pool` times `shape` with about a third of
    the pooled cells occupied."""
    dense = 1 - (2 / 3) ** (1 / pool ** 3)
    return (r.random(tuple(pool * n for n in shape)) < dense
            ).astype(np.uint8)


@pytest.mark.parametrize("pool", [1, 2, 3])
@pytest.mark.parametrize("boxes", BOXES)
def test_pooled_classify_extrap_plain_matches_jax(boxes, pool):
    """Stages 01-06: the plain version on the detailed occupancy against
    JAX's stage-01 reduce_window max-pool, then its kernel."""
    jcfg, cfg = configs(solid_boxes=boxes, surface_render_resolution=pool)
    _, _, vel, _ = fields(6)
    r = np.random.default_rng(7 + pool)
    occ = sparse_occupancy(r, GRID, pool)
    old = r.integers(0, 4, GRID).astype(np.uint8)
    occ_sim = occupancy_to_sim_grid(jnp.asarray(occ), jcfg)
    want_t, want_v = classify_extrap_pallas(
        occ_sim, jnp.asarray(old), jnp.asarray(vel), jcfg, interpret=True)
    got_t, got_v = classify_extrap_plain(T(occ), T(old), T(vel), cfg,
                                         pool=pool)
    same(got_t, want_t)
    same(got_v, want_v, ulp=1)
    # every type occurs, so each branch of stages 02-05 ran
    assert set(np.unique(got_t.numpy())) == {0, 1, 2, 3}


@pytest.mark.parametrize("extra", FORCES)
@pytest.mark.parametrize("boxes", BOXES)
def test_forces_solids_div_plain_matches_pallas_interpret(boxes, extra):
    jcfg, cfg = configs(solid_boxes=boxes, extra_forces=extra,
                        fountain_position=(12, 9, 6))
    occ, types, vel, _ = fields(2)
    # the fountain cell and the extra-force cells wet, so the forces land
    types[12, 8:10, 6] = 2
    types[5, 3:5, 3], types[11, 6:8, 6] = 2, 2
    want_v, want_div = forces_solids_div_pallas(
        jnp.asarray(types), jnp.asarray(vel), jcfg, interpret=True)
    got_v, got_div = forces_solids_div_plain(T(types), T(vel), cfg)
    same(got_v, want_v, ulp=1)
    same(got_div, want_div, ulp=1)


def test_forces_reach_the_wet_faces():
    """With gravity off and no solid cells, the fountain and the extra
    forces change exactly the lower faces of their own wet cells, so the
    parity cases above exercise them."""
    _, cfg = configs(extra_forces=FORCES[1], fountain_position=(12, 9, 6),
                     gravity=0.0)
    _, types, vel, _ = fields(2)
    types[:] = 0
    types[12, 9, 6] = types[5, 4, 3] = types[11, 7, 6] = 2
    out, _ = forces_solids_div_plain(T(types), T(vel), cfg)
    moved = (out != T(vel)).nonzero().tolist()
    assert sorted(moved) == [[0, 5, 4, 3], [1, 11, 7, 6], [1, 12, 9, 6],
                             [2, 5, 4, 3]]


def test_project_plain_matches_pallas_interpret():
    jcfg, cfg = configs(dt=0.013, fluid_density=0.7, cell_width=1.3)
    _, types, vel, p = fields(3)
    want = project_pallas(jnp.asarray(types), jnp.asarray(p),
                          jnp.asarray(vel), jcfg, interpret=True)
    got = project_plain(T(types), T(p), T(vel), cfg)
    same(got, want, ulp=1)


# ------------------------------------------------------------------ wrappers
def wrapper_calls(device="cpu"):
    """(wrapper, plain, args) for the three K6 wrappers at a small shape,
    with a solid box and extra forces: cases of the wrapper tests in
    tests/test_torch_kernels.py."""
    cfg = FluidConfig(grid_size=GRID, solid_boxes=BOXES[1],
                      extra_forces=FORCES[1], fountain_position=(12, 9, 6))
    occ, types, vel, p = (T(a).to(device) for a in fields(4))
    return [
        (classify_extrap_cuda, classify_extrap_plain,
         (occ, types, vel, cfg)),
        (forces_solids_div_cuda, forces_solids_div_plain, (types, vel, cfg)),
        (project_cuda, project_plain, (types, p, vel, cfg)),
    ]


# K6a at pools 1-3, K6b and K6c at odd non-cubic grids: several y and z
# tiles and x segments on the card
ODD_GRIDS = [(13, 22, 17), (37, 45, 29)]
POOLS = [1, 2, 3]


def odd_wrapper_calls(device="cpu"):
    """(wrapper, plain, args, kwargs): K6a at each pool, K6b and K6c, at
    each odd grid, with a solid box and an extra force, and the fountain
    and the force cell wet; then K6a with no solid box: cases of the
    wrapper tests in tests/test_torch_kernels.py."""
    calls = []
    for i, shape in enumerate(ODD_GRIDS):
        r = np.random.default_rng(50 + i)
        gx, gy, gz = shape
        fountain = (gx // 2, gy - 3, gz // 2)
        force_cell = (gx // 3, gy // 2, gz // 3)
        cfg = FluidConfig(grid_size=shape, fountain_position=fountain,
                          solid_boxes=(((gx // 4, 2, 3),
                                        (gx // 2, gy // 2, gz - 4)),),
                          extra_forces=((force_cell, (40.0, 0.0, -25.0)),))
        old = r.integers(0, 4, shape).astype(np.uint8)
        vel = (3.0 * r.standard_normal((3,) + shape)).astype(np.float32)
        for pool in POOLS:
            args = (sparse_occupancy(r, shape, pool), old, vel)
            calls.append((classify_extrap_cuda, classify_extrap_plain,
                          tuple(T(a).to(device) for a in args) + (cfg,),
                          {"pool": pool}))
        types = r.integers(0, 4, shape).astype(np.uint8)
        for cell in (fountain, force_cell):
            types[cell[0], cell[1] - 1:cell[1] + 1, cell[2]] = 2
        calls.append((forces_solids_div_cuda, forces_solids_div_plain,
                      (T(types).to(device), T(vel).to(device), cfg), {}))
        p = (50.0 * r.standard_normal(shape)).astype(np.float32)
        calls.append((project_cuda, project_plain,
                      tuple(T(a).to(device) for a in (types, p, vel))
                      + (cfg,), {}))
    # no solid box, as in the scaled scenes
    occ = sparse_occupancy(r, shape, 2)
    calls.append((classify_extrap_cuda, classify_extrap_plain,
                  tuple(T(a).to(device) for a in (occ, old, vel))
                  + (cfg.replace(solid_boxes=()),), {"pool": 2}))
    return calls


def test_wrappers_reject_bad_inputs():
    cfg = FluidConfig(grid_size=GRID)
    occ, types, vel, p = map(T, fields(5))
    with pytest.raises(TypeError):
        classify_extrap_cuda(occ.to(torch.int32), types, vel, cfg)
    with pytest.raises(ValueError):
        classify_extrap_cuda(occ, types[:3], vel, cfg)
    with pytest.raises(ValueError):
        classify_extrap_cuda(occ, types, vel, cfg, pool=2)
    with pytest.raises(ValueError):
        classify_extrap_cuda(occ, types, vel, cfg, pool=0)
    # at pool 2 the occupancy must start on a 2-byte boundary
    fine = T(sparse_occupancy(np.random.default_rng(5), GRID, 2))
    odd = torch.empty(fine.numel() + 1, dtype=torch.uint8)[1:]
    odd.copy_(fine.flatten())
    with pytest.raises(ValueError, match="2-byte"):
        classify_extrap_cuda(odd.reshape(fine.shape), types, vel, cfg,
                             pool=2)
    with pytest.raises(ValueError):
        forces_solids_div_cuda(types, vel[:2], cfg)
    with pytest.raises(TypeError):
        forces_solids_div_cuda(types, vel.double(), cfg)
    with pytest.raises(TypeError):
        project_cuda(types, p.double(), vel, cfg)
    with pytest.raises(ValueError):
        project_cuda(types, p.transpose(0, 2), vel, cfg)


# ------------------------------------------------------------- K6c slabs
# Stage 13 reads only lower neighbours, and K6c's halo form reads of its
# halo planes only the left ones of the types and pressure.  Its slabs
# stitched together equal the single-device form, with the right planes
# and both velocity planes NaN (the right type plane WATER).
PROJECT_SLABS = 4


def project_by_slabs(wrapper, types, p, vel, cfg):
    gx, n = types.shape[0], PROJECT_SLABS
    lx = gx // n
    out = []
    for k in range(n):
        rows = slice(k * lx, (k + 1) * lx)
        left = slice(k * lx - 1, k * lx) if k else None

        def halo(a):
            lo = (a[..., left, :, :] if left else
                  torch.zeros_like(a[..., :1, :, :]))
            return (lo.contiguous(),
                    torch.full_like(a[..., :1, :, :],
                                    2 if a.dtype == torch.uint8
                                    else float("nan")))

        def nan_pair(a):
            return tuple(torch.full_like(a[:, :1], float("nan"))
                         for _ in range(2))

        out.append(wrapper(
            *(a[..., rows, :, :].contiguous() for a in (types, p, vel)),
            cfg, halos=(halo(types), halo(p), nan_pair(vel)), x0=k * lx,
            global_gx=gx))
    return torch.cat(out, dim=1)


def project_slab_case(device):
    _, cfg = configs(dt=0.013, fluid_density=0.7, cell_width=1.3)
    _, types, vel, p = fields(6)
    return tuple(T(a).to(device) for a in (types, p, vel)) + (cfg,)


def test_project_slabs_equal_the_single_device_form():
    args = project_slab_case("cpu")
    same(project_by_slabs(project_halo_plain, *args), project_plain(*args))
    same(project_by_slabs(project_halo_cuda, *args), project_cuda(*args))


@pytest.mark.cuda
def test_cuda_project_slabs_equal_the_single_device_form():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are compiled and run "
                    "only there")
    args = project_slab_case(torch.device("cuda", 0))
    whole = project_cuda(*args)
    slabs = project_by_slabs(project_halo_cuda, *args)
    torch.cuda.synchronize()
    assert torch.equal(slabs, whole)
    assert torch.equal(whole, project_plain(*args))
