"""Particles at NaN, infinite and huge positions: the port's stage 14 and
15 against the JAX package on the CPU, on the same numpy inputs.

JAX converts a float to an integer with XLA's rules (a NaN to 0, values
beyond the type saturated) and turns the TPU kernel's mask products into
selects, so a NaN coordinate weighs 0 on its axis.  The port's plain
versions, which K3+K4 is held against bitwise on the card, must give the
same: a particle with one NaN coordinate moves only that coordinate to
NaN, an infinite coordinate samples the edge cell, and a NaN position's
occupancy lands at detailed index 0 on its NaN axes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_fluid.core.config import FluidConfig as JaxConfig
from tpu_fluid.kernels.pack_table import (build_packed_table_pallas,
                                          build_packed_table_pallas2)
from tpu_fluid.kernels.particle_sample import sample_and_move
from tpu_fluid.ops import packed_sampler as jps
from tpu_fluid.stages import particles as jparticles
from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.kernels.particle_move import (
    particle_move_occupancy_plain, particle_move_plain, scatter_occupancy)
from tpu_fluid_torch.ops import packed_sampler as ps
from tpu_fluid_torch.ops.indexing import float_to_index
from tpu_fluid_torch.stages import particles

NAN, INF = float("nan"), float("inf")
EPS = np.finfo(np.float32).eps
# 20^3-like (the 64-lane table) and z-paired (the 128-lane table at z >= 128)
SHAPES = [(20, 20, 20), (4, 8, 128)]


def inputs(shape, seed):
    r = np.random.default_rng(seed)
    vel = (r.standard_normal((3,) + shape) * 4).astype(np.float32)
    pos = (r.random((64, 3)) * (np.array(shape) - 1) + 0.5).astype(np.float32)
    return vel, pos, np.ones(len(pos), bool)


def with_nan_axes(pos):
    """Rows 0-6: NaN on x, y, z, on (x, y), (x, z), (y, z) and on all
    three; the other rows finite."""
    pos = pos.copy()
    for row, axes in enumerate(((0,), (1,), (2,), (0, 1), (0, 2), (1, 2),
                                (0, 1, 2))):
        pos[row, list(axes)] = NAN
    return pos


def with_extremes(pos):
    """Rows 0-11: +-inf and +-1e30 on each axis, the others finite."""
    pos = pos.copy()
    for row, (d, value) in enumerate((d, v) for d in range(3)
                                     for v in (INF, -INF, 1e30, -1e30)):
        pos[row, d] = value
    return pos


def jax_move(vel, pos, act, shape, dt=0.01):
    """JAX's Pallas route, interpreted: the paired table at z >= 128."""
    paired = shape[2] >= 128
    build = build_packed_table_pallas2 if paired else build_packed_table_pallas
    rows_of = jps.packed_row_indices2 if paired else jps.packed_row_indices
    table = build(jnp.asarray(vel), interpret=True)
    rows = jnp.take(table, rows_of(jnp.asarray(pos), shape), axis=0,
                    mode="clip")
    return np.asarray(sample_and_move(rows, jnp.asarray(pos).T,
                                      jnp.asarray(act), shape, dt,
                                      interpret=True).T)


def assert_same(got, want, ulp=1):
    """NaNs in the same places; infinities equal; the finite values within
    `ulp` of the largest."""
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    finite = np.isfinite(w)
    np.testing.assert_array_equal(g[~finite & ~np.isnan(w)],
                                  w[~finite & ~np.isnan(w)])
    scale = float(np.abs(w[finite]).max())
    np.testing.assert_allclose(g[finite], w[finite], rtol=ulp * EPS,
                               atol=ulp * EPS * scale)


@pytest.mark.parametrize("shape", SHAPES)
def test_nan_axis_moves_only_that_coordinate(shape):
    """One, two and three NaN coordinates: K3+K4's plain version moves
    exactly the NaN coordinates to NaN, as JAX's interpreted kernel does,
    and leaves the others where they were."""
    vel, pos, act = inputs(shape, 1)
    pos = with_nan_axes(pos)
    want = jax_move(vel, pos, act, shape)
    got = particle_move_plain(torch.from_numpy(vel), torch.from_numpy(pos),
                              torch.from_numpy(act), 0.01)
    assert_same(got, want)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(pos))
    nan_rows = np.isnan(pos).any(axis=1)
    kept = ~np.isnan(pos) & nan_rows[:, None]
    np.testing.assert_array_equal(got.numpy()[kept], pos[kept])


@pytest.mark.parametrize("shape", SHAPES)
def test_packed_sampler_weighs_a_nan_axis_zero(shape):
    """`ops/packed_sampler` (the JAX package's XLA formulation): the
    velocity of a particle with a NaN coordinate is NaN only in that
    component, 0 in the others, as JAX's."""
    vel, pos, _ = inputs(shape, 2)
    pos = with_nan_axes(pos)
    want = jps.sample_velocity_packed(jps.build_packed_table(
        jnp.asarray(vel)), shape, jnp.asarray(pos))
    got = ps.sample_velocity_packed(ps.build_packed_table(
        torch.from_numpy(vel)), shape, torch.from_numpy(pos))
    assert_same(got, want, ulp=4)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(pos))


@pytest.mark.parametrize("shape", SHAPES)
def test_infinite_and_huge_coordinates_sample_the_edge(shape):
    """+-inf and +-1e30: the cell index clamps in the float domain and
    converts as XLA does, so the row gathered is the edge cell's, where x86
    turned the int64 conversion into cell 0's."""
    vel, pos, act = inputs(shape, 3)
    pos = with_extremes(pos)
    np.testing.assert_array_equal(
        ps.packed_row_indices(torch.from_numpy(pos), shape).numpy(),
        np.asarray(jps.packed_row_indices(jnp.asarray(pos), shape)))
    want = jax_move(vel, pos, act, shape)
    got = particle_move_plain(torch.from_numpy(vel), torch.from_numpy(pos),
                              torch.from_numpy(act), 0.01)
    assert_same(got, want)
    v_want = jps.sample_velocity_packed(jps.build_packed_table(
        jnp.asarray(vel)), shape, jnp.asarray(pos))
    v_got = ps.sample_velocity_packed(ps.build_packed_table(
        torch.from_numpy(vel)), shape, torch.from_numpy(pos))
    assert_same(v_got, v_want, ulp=4)


def occupancy_positions():
    """NaN on each axis and on all three, +-inf, +-1e30, beyond 2^31 once
    scaled, and finite positions, all active but the last two."""
    pos = np.array([
        (NAN, 2.3, 4.1), (3.2, NAN, 1.7), (5.5, 6.5, NAN), (NAN, NAN, NAN),
        (INF, 1.0, 1.0), (-INF, 1.0, 1.0), (1.0, 1e30, 1.0),
        (1.0, 1.0, -1e30), (3e9, 1.0, 1.0), (2.5, 3.5, 4.5),
        (7.9, 0.2, 6.6), (NAN, 1.1, 1.1), (1.2, 1.3, 1.4)], np.float32)
    act = np.ones(len(pos), bool)
    act[-2:] = False
    return pos, act


def test_nan_position_occupies_index_zero():
    """Stage 15 against JAX's `detailed_occupancy`: a NaN coordinate's
    truncated index converts to 0, so the particle writes detailed cell 0
    on that axis; infinite and huge positions are dropped."""
    pos, act = occupancy_positions()
    jcfg = JaxConfig(grid_size=(8, 8, 8), surface_render_resolution=2)
    cfg = FluidConfig(grid_size=(8, 8, 8), surface_render_resolution=2)
    want = np.asarray(jparticles.detailed_occupancy(
        jnp.asarray(pos), jnp.asarray(act), jcfg))
    got = particles.detailed_occupancy(torch.from_numpy(pos),
                                       torch.from_numpy(act), cfg)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, 4, 8] and want[6, 0, 3] and want[11, 13, 0]
    assert want[0, 0, 0] and int(want.sum()) == 6


def test_move_and_scatter_nan_positions_match_jax():
    """K3+K4's plain version, moved positions and occupancy at once: the
    NaN rows' occupancy lands at index 0 on their NaN axes."""
    shape = (8, 8, 8)
    r = np.random.default_rng(4)
    vel = (r.standard_normal((3,) + shape) * 4).astype(np.float32)
    pos, act = occupancy_positions()
    jcfg = JaxConfig(grid_size=shape, surface_render_resolution=2,
                     pallas_mode="interpret")
    jpos = jparticles.move_particles(jnp.asarray(vel), jnp.asarray(pos),
                                     jnp.asarray(act), jcfg)
    jocc = jparticles.detailed_occupancy(jpos, jnp.asarray(act), jcfg)
    got, occ = particle_move_occupancy_plain(
        torch.from_numpy(vel), torch.from_numpy(pos), torch.from_numpy(act),
        jcfg.dt, 2)
    assert_same(got, jpos)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    assert np.asarray(jocc)[0].any()


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_float_to_index_converts_as_xla(dtype):
    x = np.array([NAN, INF, -INF, 1e30, -1e30, 3e9, -3e9, 2.0 ** 31,
                  -2.0 ** 31, 2.0 ** 63, -2.0 ** 63, 7.0, -7.0, -0.0, 0.0],
                 np.float32)
    if dtype == torch.int32:
        want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    else:
        # JAX keeps 64-bit types off by default: XLA's rule written out
        info = np.iinfo(np.int64)
        with np.errstate(invalid="ignore"):
            cast = np.nan_to_num(x, posinf=0, neginf=0).astype(np.int64)
        want = np.where(np.isnan(x), 0, np.where(
            x >= 2.0 ** 63, info.max, np.where(x < -2.0 ** 63, info.min,
                                               cast)))
    got = float_to_index(torch.from_numpy(x), dtype)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_occupancy_drops_what_jax_drops():
    """Positions beyond int64 once scaled are dropped, not wrapped into the
    grid."""
    pos = torch.tensor([[1e30, 1.0, 1.0], [-1e38, 1.0, 1.0],
                        [1.0, 1.0, 1.0]])
    occ = scatter_occupancy(pos, torch.ones(3, dtype=torch.bool), 2,
                            (4, 4, 4))
    assert int(occ.sum()) == 1 and occ[2, 2, 2]
