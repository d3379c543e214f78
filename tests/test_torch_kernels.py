"""The port's kernels: each plain PyTorch version against the JAX
package's Pallas kernel run in the Pallas interpreter (as
tests/test_fast_paths.py and tests/test_surface_fused.py run them), also
against the TPU tiling variants that K1, K2 and K5 cover on the card
(`advect_one_pallas`, `advect_component_pallas`, the slab branch of
`jacobi_sweeps_pallas`, `surface_fused_2d`); the wrappers' checks and CPU
routing; and, on a CUDA card only, each CUDA kernel, K6 of
tests/test_torch_grid_fused.py included, against its plain version (marked
`cuda`; they skip without a card).

Integer results must be equal.  f32 results allow 1-2 ULP of the field's
scale where stated: XLA:CPU may contract a*b+c into one fused multiply-add
inside the interpreted kernel, where the plain version rounds twice (the
allowance of commit 5687bef).  On the card the CUDA kernels are built with
-fmad=false and must match their plain versions bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_grid_fused import odd_wrapper_calls as odd_grid_fused_calls
from test_torch_grid_fused import wrapper_calls as grid_fused_calls
from tpu_fluid.kernels.advect import (advect_all_pallas,
                                      advect_component_pallas,
                                      advect_one_pallas)
from tpu_fluid.kernels.jacobi import jacobi_sweeps_pallas
from tpu_fluid.kernels.pack_table import (build_packed_table_pallas,
                                          build_packed_table_pallas2)
from tpu_fluid.kernels.particle_sample import sample_and_move
from tpu_fluid.kernels.surface_fused import (surface_fused_2d,
                                             surface_fused_pallas)
from tpu_fluid.core.config import FluidConfig as JaxConfig
from tpu_fluid.ops.packed_sampler import (packed_row_indices,
                                          packed_row_indices2)
from tpu_fluid.stages import particles as jparticles
from tpu_fluid.stages.velocity import advect_pallas
from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.kernels import build
from tpu_fluid_torch.kernels.advect import (advect_all_cuda,
                                            advect_all_plain,
                                            advect_from_types_plain,
                                            face_center_velocity)
from tpu_fluid_torch.kernels.jacobi import (jacobi_fold_cuda,
                                            jacobi_fold_plain,
                                            jacobi_sweeps_cuda,
                                            jacobi_sweeps_plain)
from tpu_fluid_torch.kernels.particle_move import (
    particle_move_cuda, particle_move_occupancy_plain, particle_move_plain)
from tpu_fluid_torch.kernels.surface_fused import (surface_fused_cuda,
                                                   surface_fused_plain)
from tpu_fluid_torch.ops.packed_sampler import build_packed_table
from tpu_fluid_torch.stages.surface_fields import solid_parent_mask

torch.set_num_threads(2)
EPS = np.finfo(np.float32).eps


def T(a):
    return torch.from_numpy(np.array(a))


def same(got, want, ulp=0):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype
    if ulp == 0:
        np.testing.assert_array_equal(g, w)
    else:
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=ulp * EPS,
                                   atol=ulp * EPS * scale)


def random_types(r, shape):
    t = np.where(r.random(shape) < 0.4, 2, 0).astype(np.uint8)
    t[0], t[-1], t[:, 0], t[:, -1], t[:, :, 0], t[:, :, -1] = (3,) * 6
    t[(t == 0) & (r.random(shape) < 0.3)] = 1
    return t


# ------------------------------------------------------------------ inputs
def advect_inputs(shape, seed):
    r = np.random.default_rng(seed)
    vel = (r.standard_normal((3,) + shape) * 80).astype(np.float32)
    cond3 = (r.random((3,) + shape) < 0.6).astype(np.uint8)
    return vel, cond3


def jacobi_inputs(n, seed):
    """(q0, code, c2e): K2's folded inputs.  JAX's sweeps fold c2
    themselves, and c2e folds to itself."""
    shape = n if isinstance(n, tuple) else (n, n, n)
    r = np.random.default_rng(seed)
    types = T(random_types(r, shape))
    div = T((r.standard_normal(shape) * 50).astype(np.float32))
    return jacobi_fold_plain(types, div, 1.0, 1.0)


def particle_inputs(shape, p, seed):
    r = np.random.default_rng(seed)
    vel = (r.standard_normal((3,) + shape) * 4).astype(np.float32)
    pos = (r.random((p, 3)) * (np.array(shape) + 2) - 1).astype(np.float32)
    act = r.random(p) < 0.9
    return vel, pos, act


def surface_inputs(cfg, seed, inertia_dtype=np.uint8):
    r = np.random.default_rng(seed)
    d = cfg.detailed_size
    occ = (r.random(d) < 0.3).astype(np.uint8)
    inertia = r.integers(0, cfg.max_inertia + 1, d).astype(inertia_dtype)
    f2 = r.normal(size=d).astype(np.float32)
    types = r.integers(0, 4, cfg.grid_size).astype(np.uint8)
    skip = solid_parent_mask(T(types), cfg).to(torch.uint8).numpy()
    return occ, inertia, f2, skip


def surface_kw(cfg):
    return dict(steps=cfg.float_density_diffuse_steps,
                k=cfg.float_density_diffuse_coefficient,
                inc_filled=cfg.inertia_increase_filled,
                inc_neigh=cfg.inertia_increase_neighbour,
                required_hits=cfg.inertia_required_neighbour_hits,
                dec=cfg.inertia_decrease, max_inertia=cfg.max_inertia,
                div_coef=cfg.float_density_division_coefficient)


# ------------------------------------------------------------------ K1
@pytest.mark.parametrize("shape", [(10, 10, 10), (8, 12, 16)])
def test_advect_plain_matches_pallas_interpret(shape):
    vel, cond3 = advect_inputs(shape, 0)
    got = advect_all_plain(T(vel), T(cond3), 2, 0.01)
    want = advect_all_pallas(jnp.asarray(vel), jnp.asarray(cond3), 2, 0.01,
                             interpret=True)
    same(got, want, ulp=1)


@pytest.mark.parametrize("shape,tx", [((8, 12, 16), 2), ((4, 130, 132), 4)])
def test_advect_one_pallas_is_covered_by_k1(shape, tx):
    """advect_one_pallas, the one-component kernel JAX runs for y*z planes
    above 128^2 (tx = 2 at 256^3), against K1's plain version component by
    component; the second shape has such a plane."""
    vel, cond3 = advect_inputs(shape, 15)
    got = advect_all_plain(T(vel), T(cond3), 2, 0.01)
    for c in range(3):
        want = advect_one_pallas(jnp.asarray(vel), jnp.asarray(cond3[c]), c,
                                 2, 0.01, tx=tx, interpret=True)
        same(got[c], want, ulp=1)


def test_advect_component_pallas_is_covered_by_k1():
    """advect_component_pallas, called directly (the step cannot reach it
    at R = 2), from JAX's precomputed displacement u = -v_face * dt."""
    shape = (6, 12, 10)
    vel, cond3 = advect_inputs(shape, 16)
    got = advect_all_plain(T(vel), T(cond3), 2, 0.01)
    for c in range(3):
        u = -face_center_velocity(T(vel), c).numpy() * np.float32(0.01)
        want = advect_component_pallas(jnp.asarray(vel[c]), jnp.asarray(u),
                                       jnp.asarray(cond3[c]), 2, tx=2,
                                       interpret=True)
        same(got[c], want, ulp=1)


@pytest.mark.parametrize("shape", [(10, 10, 10), (8, 12, 16)])
def test_advect_from_types_matches_jax_advect_pallas(shape):
    """K1 with its condition masks taken in: the port's plain route from
    the cell types against JAX's stage 07 on its Pallas route, which builds
    the masks and runs advect_all_pallas (interpreted)."""
    r = np.random.default_rng(40)
    vel = (r.standard_normal((3,) + shape) * 80).astype(np.float32)
    types = random_types(r, shape)
    jcfg = JaxConfig(grid_size=shape)
    want = advect_pallas(jnp.asarray(types), jnp.asarray(vel), jcfg,
                         interpret=True)
    got = advect_from_types_plain(T(vel), T(types),
                                  jcfg.advect_max_displacement, jcfg.dt)
    same(got, want, ulp=1)


def non_finite_velocity(shape, seed, r=2):
    """Velocities with NaNs and infinities of both signs at rows R .. X-R-1
    (JAX's single-block kernel fills its x halo from the block's far rows,
    where the port replicates the edge), a +inf beside a -inf among them."""
    rng = np.random.default_rng(seed)
    vel = (rng.standard_normal((3,) + shape) * 80).astype(np.float32)
    for k, value in enumerate((np.nan, np.inf, -np.inf) * 3):
        vel[k % 3, rng.integers(r, shape[0] - r), rng.integers(0, shape[1]),
            rng.integers(0, shape[2])] = value
    mid = tuple(n // 2 for n in shape)
    vel[(0,) + mid], vel[(2,) + mid] = np.inf, -np.inf
    return vel, random_types(rng, shape)


def same_non_finite(got, want, ulp):
    """NaNs and infinities in the same places, finite values within ulp."""
    g, w = got.numpy(), np.asarray(want)
    finite = np.isfinite(w)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_array_equal(g[np.isinf(w)], w[np.isinf(w)])
    assert np.isnan(w).any() and np.isfinite(g[finite]).all()
    same(T(g[finite]), w[finite], ulp=ulp)


@pytest.mark.parametrize("shape", [(10, 10, 10), (8, 12, 16)])
def test_advect_from_types_non_finite_matches_jax(shape):
    """Stage 07 on NaN and infinite velocities: the port's plain route, the
    one K1 is held against on the card, puts NaN where JAX's interpreted
    kernel does (a zero weight times an infinity is NaN in both masked
    sums)."""
    vel, types = non_finite_velocity(shape, 41)
    jcfg = JaxConfig(grid_size=shape)
    want = advect_pallas(jnp.asarray(types), jnp.asarray(vel), jcfg,
                         interpret=True)
    got = advect_from_types_plain(T(vel), T(types),
                                  jcfg.advect_max_displacement, jcfg.dt)
    same_non_finite(got, want, ulp=1)


# ------------------------------------------------------------------ K2
@pytest.mark.parametrize("n,iters", [(12, 17), (16, 9)])
def test_jacobi_plain_matches_pallas_interpret(n, iters):
    q0, code, c2e = jacobi_inputs(n, 1)
    got = jacobi_sweeps_plain(q0, code, c2e, iters)
    want = jacobi_sweeps_pallas(jnp.asarray(q0.numpy()),
                                jnp.asarray(code.numpy()),
                                jnp.asarray(c2e.numpy()), iters,
                                interpret=True, whole_grid=True)
    same(got, want, ulp=1)


@pytest.mark.parametrize("k,iters", [(4, 8), (3, 9), (4, 11)])
def test_jacobi_slab_branch_is_covered_by_k2(k, iters):
    """The slab branch (`_one_pass`), which JAX runs above 128^3 cells,
    against K2's plain version on the u8 code: k = 4 reads its halos
    directly (4 | tx), k = 3 materialises them, and 11 = 2 * 4 + 3 sweeps
    end in a remainder pass of 3."""
    q0, code, c2e = jacobi_inputs(16, 17)
    got = jacobi_sweeps_plain(q0, code, c2e, iters)
    want = jacobi_sweeps_pallas(jnp.asarray(q0.numpy()),
                                jnp.asarray(code.numpy()),
                                jnp.asarray(c2e.numpy()), iters, k=k, tx=16,
                                interpret=True, whole_grid=False)
    same(got, want, ulp=1)


def test_jacobi_zero_iterations_is_identity():
    q0, code, c2e = jacobi_inputs(6, 2)
    same(jacobi_sweeps_plain(q0, code, c2e, 0), q0.numpy())


# ------------------------------------------------------------------ K3+K4
@pytest.mark.parametrize("shape", [(10, 10, 10), (6, 9, 12)])
def test_particle_move_plain_matches_pallas_interpret(shape):
    vel, pos, act = particle_inputs(shape, 2048, 3)
    table = build_packed_table_pallas(jnp.asarray(vel), interpret=True)
    same(build_packed_table(T(vel)), table)
    rows = jnp.take(table, packed_row_indices(jnp.asarray(pos), shape),
                    axis=0, mode="clip")
    want = sample_and_move(rows, jnp.asarray(pos).T, jnp.asarray(act),
                           shape, 0.01, interpret=True).T
    got = particle_move_plain(T(vel), T(pos), T(act), 0.01)
    same(got, want, ulp=1)


def test_particle_move_plain_matches_paired_table_interpret():
    """At z >= 128 the TPU path pairs cells z and z+Z/2 in 128-lane rows
    (tests/test_fast_paths.py:156); the fused kernel has one formulation
    for both tables."""
    shape = (4, 8, 128)
    vel, pos, act = particle_inputs(shape, 512, 4)
    table2 = build_packed_table_pallas2(jnp.asarray(vel), interpret=True)
    rows = jnp.take(table2, packed_row_indices2(jnp.asarray(pos), shape),
                    axis=0, mode="clip")
    want = sample_and_move(rows, jnp.asarray(pos).T, jnp.asarray(act),
                           shape, 0.01, interpret=True).T
    got = particle_move_plain(T(vel), T(pos), T(act), 0.01)
    same(got, want, ulp=1)


def scatter_particles(shape, seed):
    """Random positions around the grid, then particles in (-1, 0) on
    each axis, out of the grid on each side, a cluster of 40 in one
    detailed cell, and inactive ones among them."""
    r = np.random.default_rng(seed)
    vel = (r.standard_normal((3,) + shape) * 4).astype(np.float32)
    top = np.array(shape, dtype=np.float64)
    pos = [r.random((600, 3)) * (top + 2) - 1]
    for d in range(3):
        p = r.random((20, 3)) * top
        p[:, d] = -r.random(20) * 0.999
        pos.append(p)
        p = r.random((20, 3)) * top
        p[:, d] = np.where(np.arange(20) % 2, top[d] + 0.6 + r.random(20),
                           -1.5 - r.random(20))
        pos.append(p)
    pos.append(top * 0.37 + r.random((40, 3)) * 1e-4)
    pos = np.concatenate(pos).astype(np.float32)
    act = r.random(len(pos)) < 0.85
    return vel, pos, act


@pytest.mark.parametrize("shape", [(10, 10, 10), (4, 8, 128)])
def test_move_and_scatter_matches_jax_move_and_occupancy(shape):
    """K3+K4 with stage 15 taken in: its plain version against JAX's
    move_particles on its Pallas route (interpreted: the 64-lane table at
    (10, 10, 10), the z-paired 128-lane table at gz = 128) followed by
    detailed_occupancy.  The cluster fills one detailed cell many times."""
    vel, pos, act = scatter_particles(shape, 41)
    jcfg = JaxConfig(grid_size=shape, surface_render_resolution=2,
                     pallas_mode="interpret")
    jpos = jparticles.move_particles(jnp.asarray(vel), jnp.asarray(pos),
                                     jnp.asarray(act), jcfg)
    jocc = jparticles.detailed_occupancy(jpos, jnp.asarray(act), jcfg)
    got, occ = particle_move_occupancy_plain(T(vel), T(pos), T(act),
                                             jcfg.dt, 2)
    same(got, jpos, ulp=1)
    same(occ, jocc)
    assert 0 < int(occ.sum()) < int(act.sum())


# ------------------------------------------------------------------ K5
@pytest.mark.parametrize("steps", [0, 1, 3, 4])
def test_surface_plain_matches_pallas_interpret(steps):
    cfg = FluidConfig.scaled_scene(16, particle_count=1000, jacobi_iters=2
                                   ).replace(float_density_diffuse_steps=steps)
    occ, inertia, f2, skip = surface_inputs(cfg, 5)
    got = surface_fused_plain(T(occ), T(inertia), T(f2), T(skip),
                              **surface_kw(cfg))
    want = surface_fused_pallas(*map(jnp.asarray, (occ, inertia, f2, skip)),
                                interpret=True, **surface_kw(cfg))
    same(got[0], want[0])
    same(got[1], want[1], ulp=2)
    same(got[2], want[2], ulp=2)


@pytest.mark.parametrize("steps", [0, 2, 3])
def test_surface_fused_2d_is_covered_by_k5(steps):
    """surface_fused_2d, the (x, y)-tiled kernel JAX runs for detailed
    planes above MAX_PLANE (512^3 at scaled_scene(256)), with 8 x 8 tiles
    on a 32^3 detailed grid (tests/test_surface_fused.py:135-169)."""
    cfg = FluidConfig.scaled_scene(16, particle_count=1000, jacobi_iters=2
                                   ).replace(float_density_diffuse_steps=steps)
    occ, inertia, f2, skip = surface_inputs(cfg, 18)
    hh = next(d for d in range(steps + 1, 17)
              if 32 % d == 0 and (2 * d) % 8 == 0)
    got = surface_fused_plain(T(occ), T(inertia), T(f2), T(skip),
                              **surface_kw(cfg))
    want = surface_fused_2d(*map(jnp.asarray, (occ, inertia, f2, skip)),
                            tile=(8, 8, hh, hh), interpret=True,
                            **surface_kw(cfg))
    for g, w, ulp in zip(got, want, (0, 2, 2)):
        same(g, w, ulp=ulp)


@pytest.mark.parametrize("inertia_dtype", [np.uint8, np.int32])
def test_surface_plain_noncubic_obstacles(inertia_dtype):
    kw = dict(grid_size=(8, 12, 16), particle_count=100,
              particle_init_cube_resolution=(4, 5, 5), jacobi_iters=2,
              surface_render_resolution=2,
              solid_boxes=(((2, 2, 2), (4, 4, 4)),))
    cfg = FluidConfig(**kw)
    if inertia_dtype == np.int32:
        cfg = cfg.replace(max_inertia=300)
    occ, inertia, f2, skip = surface_inputs(cfg, 6, inertia_dtype)
    got = surface_fused_plain(T(occ), T(inertia), T(f2), T(skip),
                              **surface_kw(cfg))
    want = surface_fused_pallas(*map(jnp.asarray, (occ, inertia, f2, skip)),
                                interpret=True, **surface_kw(cfg))
    for g, w, ulp in zip(got, want, (0, 2, 2)):
        same(g, w, ulp=ulp)


# ------------------------------------------------------------------ wrappers
# K2 and K5 at odd non-cubic shapes: K2's one-block route ((13, 22, 17))
# and blocked route ((37, 45, 29): 37 rows), with a remainder pass (5 =
# 4 + 1 sweeps) and a whole solve; K5 with 0, 1, 4, 6 and 8 blur passes
# in one launch, 12 and 17 in two and three, u8 and int32 inertia
ODD_JACOBI = [((13, 22, 17), 5), ((13, 22, 17), 199), ((37, 45, 29), 5),
              ((37, 45, 29), 199)]
# K2f on finite div (tests/test_torch_jacobi_fold.py takes the non-finite)
FOLD_SHAPES = [(6, 7, 8), (13, 22, 17), (37, 45, 29)]
ODD_SURFACE = [(0, np.uint8), (1, np.int32), (4, np.uint8), (4, np.int32),
               (6, np.uint8), (8, np.int32), (12, np.uint8), (17, np.int32)]


def _wrapper_calls(device="cpu"):
    """(wrapper, plain, args, kwargs) at small shapes, then K2 and K5 at
    the odd shapes, then K6a at pools 1-3, K6b and K6c at the odd
    shapes, then K2f at a small and the odd shapes."""
    vel, _ = advect_inputs((6, 7, 8), 7)
    types = random_types(np.random.default_rng(7), (6, 7, 8))
    q0, code, c2e = jacobi_inputs(6, 8)
    pvel, pos, act = particle_inputs((6, 7, 8), 300, 9)
    cfg = FluidConfig(grid_size=(4, 5, 6), surface_render_resolution=2)
    occ, inertia, f2, skip = surface_inputs(cfg, 10)

    def dev(*a):
        return tuple(T(x).to(device) if isinstance(x, np.ndarray)
                     else x.to(device) for x in a)

    return [
        (advect_all_cuda, advect_from_types_plain,
         dev(vel, types) + (2, 0.01), {}),
        (jacobi_sweeps_cuda, jacobi_sweeps_plain, dev(q0, code, c2e) + (5,),
         {}),
        (particle_move_cuda, particle_move_occupancy_plain,
         dev(pvel, pos, act) + (0.01, 2), {}),
        (surface_fused_cuda, surface_fused_plain,
         dev(occ, inertia, f2, skip), surface_kw(cfg)),
    ] + [(wrapper, plain, args, {})
         for wrapper, plain, args in grid_fused_calls(device)] + [
        (jacobi_sweeps_cuda, jacobi_sweeps_plain,
         dev(*jacobi_inputs(shape, 20 + i)) + (n,), {})
        for i, (shape, n) in enumerate(ODD_JACOBI)] + [
        (surface_fused_cuda, surface_fused_plain,
         dev(*surface_inputs(odd_surface_cfg(steps, dtype), 30 + i, dtype)),
         surface_kw(odd_surface_cfg(steps, dtype)))
        for i, (steps, dtype) in enumerate(ODD_SURFACE)] + \
        odd_grid_fused_calls(device) + [
        (jacobi_fold_cuda, jacobi_fold_plain,
         dev(*fold_inputs(shape, 40 + i)) + (100.0, 1.0), {})
        for i, shape in enumerate(FOLD_SHAPES)]


def fold_inputs(shape, seed):
    r = np.random.default_rng(seed)
    return (random_types(r, shape),
            (r.standard_normal(shape) * 50).astype(np.float32))


def odd_surface_cfg(steps, inertia_dtype):
    cfg = FluidConfig(grid_size=(13, 11, 9), surface_render_resolution=2,
                      float_density_diffuse_steps=steps)
    return cfg.replace(max_inertia=300) if inertia_dtype == np.int32 else cfg


N_CALLS = 7 + len(ODD_JACOBI) + len(ODD_SURFACE) + 11 + len(FOLD_SHAPES)


@pytest.mark.parametrize("case", range(N_CALLS))
def test_wrapper_on_cpu_runs_plain_version_without_launch(case):
    wrapper, plain, args, kw = _wrapper_calls()[case]
    before = wrapper.launches
    got, want = wrapper(*args, **kw), plain(*args, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert wrapper.launches == before


def test_wrappers_reject_bad_inputs():
    vel, _ = map(T, advect_inputs((4, 4, 4), 11))
    types = T(random_types(np.random.default_rng(11), (4, 4, 4)))
    with pytest.raises(TypeError):
        advect_all_cuda(vel.double(), types, 2, 0.01)
    with pytest.raises(ValueError):
        advect_all_cuda(vel, types[:3], 2, 0.01)
    with pytest.raises(ValueError):
        advect_all_cuda(vel.transpose(1, 3), types, 2, 0.01)
    with pytest.raises(ValueError):
        advect_all_cuda(vel, types, 8, 0.01)
    q0, code, c2e = jacobi_inputs(4, 12)
    with pytest.raises(TypeError):
        jacobi_sweeps_cuda(q0, code.to(torch.int32), c2e, 3)
    pvel, pos, act = map(T, particle_inputs((4, 4, 4), 10, 13))
    with pytest.raises(ValueError):
        particle_move_cuda(pvel, pos.T.contiguous(), act, 0.01, 2)
    with pytest.raises(TypeError):
        particle_move_cuda(pvel, pos, act.to(torch.uint8), 0.01, 2)
    with pytest.raises(ValueError):
        particle_move_cuda(pvel, pos, act, 0.01, 0)
    cfg = FluidConfig(grid_size=(2, 2, 2), surface_render_resolution=2)
    occ, inertia, f2, skip = map(T, surface_inputs(cfg, 14))
    with pytest.raises(TypeError):
        surface_fused_cuda(occ, inertia.to(torch.int16), f2, skip,
                           **surface_kw(cfg))
    with pytest.raises(ValueError):
        surface_fused_cuda(occ, inertia, f2[:3], skip, **surface_kw(cfg))


def test_build_flags_and_sources():
    flags = build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags
    assert not any("fast_math" in f or "fast-math" in f for f in flags)
    names = [p.name for p in build.sources()]
    assert names == sorted(["advect.cu", "errors.cu", "grid_fused.cu",
                            "jacobi.cu", "jacobi_fold.cu", "levelset.cu",
                            "particle_move.cu", "splat.cu",
                            "surface_fused.cu"])
    assert build.LIBRARY.parent == build.BUILD_DIR
    assert build.BUILD_DIR.parts[-2:] == ("build", "tpu_fluid_torch")


# ------------------------------------------------------------------ on card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are compiled and run "
                    "only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(N_CALLS))
def test_cuda_kernel_matches_plain_bitwise(cuda_device, case):
    wrapper, plain, args, kw = _wrapper_calls(cuda_device)[case]
    before = wrapper.launches
    got, want = wrapper(*args, **kw), plain(*args, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.device == cuda_device and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(10, 10, 10), (37, 45, 29)])
def test_cuda_advect_non_finite_matches_plain_bitwise(cuda_device, shape):
    """K1 where a velocity window holds a NaN or an infinity (its full
    masked sum) and where it does not (its 8 taps), at R = 1, 2 and 3."""
    vel, types = non_finite_velocity(shape, 42)
    vel, types = T(vel).to(cuda_device), T(types).to(cuda_device)
    for r in (1, 2, 3):
        got = advect_all_cuda(vel, types, r, 0.01)
        want = advect_from_types_plain(vel, types, r, 0.01)
        nan = torch.isnan(want)
        assert nan.any() and torch.equal(torch.isnan(got), nan)
        assert torch.equal(got[~nan], want[~nan])
