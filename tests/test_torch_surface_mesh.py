"""Marching cubes of the PyTorch port (`tpu_fluid_torch/surface/`) against
the JAX package's jitted `extract_surface` (the program the JAX engine
runs), and mirrors of tests/test_mc_tables.py.

Tolerances against JAX: `count`, `valid` and `mesh_to_numpy`'s triangle
count bitwise; vertices within 2 ULP, normals within 1e-6 absolute.
Measured on the CPU: both bitwise (0 ULP, 0.0), every case below."""

from collections import Counter

import numpy as np
import pytest
import torch

from tpu_fluid.core.config import FluidConfig as JaxConfig
from tpu_fluid.surface import mc_tables as jax_tables
from tpu_fluid.surface.marching_cubes import default_max_cells as \
    jax_default_max_cells
from tpu_fluid.surface.marching_cubes import extract_surface as jax_extract
from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.surface.marching_cubes import (default_max_cells,
                                                    extract_surface,
                                                    mesh_to_numpy)
from tpu_fluid_torch.surface.mc_tables import (CORNERS, EDGES, MAX_TRIS,
                                               TRI_COUNTS, TRI_EDGES)

torch.set_num_threads(2)

CFG = FluidConfig(grid_size=(8, 8, 8), surface_render_resolution=2,
                  jacobi_iters=5)


def test_tables_equal_jax():
    for name in ("CORNERS", "EDGES", "TRI_COUNTS", "TRI_EDGES"):
        got, want = globals()[name], getattr(jax_tables, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert MAX_TRIS == jax_tables.MAX_TRIS


@pytest.mark.parametrize("grid,r", [((8, 8, 8), 2), ((20, 20, 20), 5),
                                    ((64, 32, 16), 2), ((256,) * 3, 2)])
def test_default_max_cells_equals_jax(grid, r):
    kw = dict(grid_size=grid, surface_render_resolution=r)
    assert default_max_cells(FluidConfig(**kw)) == \
        jax_default_max_cells(JaxConfig(**kw))


def _grid(n):
    return np.meshgrid(*[np.arange(n)] * 3, indexing="ij")


def _smooth_random(n=12, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((5, 5, 5))
    idx = np.linspace(0, 4, n)
    f = base
    for ax in range(3):
        f = np.apply_along_axis(lambda v: np.interp(idx, np.arange(5), v),
                                ax, f)
    x, y, z = _grid(n)
    border = np.minimum.reduce([x, y, z, n - 1 - x, n - 1 - y, n - 1 - z])
    return np.where(border == 0, -1.0, f).astype(np.float32)


def _sphere(n=16, c=(7.3, 7.9, 8.1), r=5.2):
    x, y, z = _grid(n)
    return (r ** 2 - ((x - c[0]) ** 2 + (y - c[1]) ** 2
                      + (z - c[2]) ** 2)).astype(np.float32)


# (field, max_cells): "overflow" has more crossing cells than max_cells,
# which both packages drop silently
CASES = {
    "sphere": (_sphere(), 8192),
    "random_smooth": (_smooth_random(), 8192),
    "random_noise": (np.random.default_rng(3).standard_normal(
        (14, 15, 16)).astype(np.float32), 8192),
    "empty": (np.full((10, 10, 10), -1.0, np.float32), 512),
    "full": (np.full((10, 10, 10), 1.0, np.float32), 512),
    "overflow": (_sphere(), 100),
}


def _ulp_diff(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    return int(np.where(same, 0, np.abs(ia - ib)).max(initial=0))


@pytest.mark.parametrize("r", [2, 5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_extract_surface_matches_jitted_jax(case, r):
    import jax
    import jax.numpy as jnp
    field, max_cells = CASES[case]
    kw = dict(grid_size=(8, 8, 8), surface_render_resolution=r)
    want = jax.jit(jax_extract, static_argnums=(1, 2))(
        jnp.asarray(field), JaxConfig(**kw), max_cells)
    got = extract_surface(torch.from_numpy(field), FluidConfig(**kw),
                          max_cells)
    assert got.count.dtype == torch.int32
    assert int(got.count) == int(want.count)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    tris, normals = mesh_to_numpy(got)
    assert len(tris) == len(normals) == int(want.count)
    if case == "overflow":
        # every cell slot holds a crossing cell: its first triangle is valid
        assert got.valid.reshape(-1, MAX_TRIS)[:, 0].all()
    valid = np.asarray(want.valid)
    assert _ulp_diff(got.vertices.numpy()[valid],
                     np.asarray(want.vertices)[valid]) <= 2
    np.testing.assert_allclose(got.normals.numpy()[valid],
                               np.asarray(want.normals)[valid], rtol=0,
                               atol=1e-6)


# ------------------------------------------- mirrors of test_mc_tables.py
def test_table_shape_and_bounds():
    assert TRI_COUNTS.shape == (256,)
    assert MAX_TRIS <= 5
    assert TRI_COUNTS.max() == MAX_TRIS
    assert TRI_COUNTS[0] == 0 and TRI_COUNTS[255] == 0
    for cfgi in range(256):
        used = TRI_EDGES[cfgi][:3 * TRI_COUNTS[cfgi]]
        assert ((used >= 0) & (used < 12)).all()
        assert (TRI_EDGES[cfgi][3 * TRI_COUNTS[cfgi]:] == 255).all()


def test_table_single_corner_configs():
    for c in range(8):
        cfgi = 1 << c
        assert TRI_COUNTS[cfgi] == 1
        used = set(TRI_EDGES[cfgi][:3].tolist())
        incident = {e for e, (a, b) in enumerate(EDGES) if c in (a, b)}
        assert used == incident


def _extract(field):
    return mesh_to_numpy(extract_surface(torch.from_numpy(field), CFG,
                                         max_cells=8192))


def _edge_key(v0, v1):
    return tuple(sorted([tuple(np.round(v0, 5)), tuple(np.round(v1, 5))]))


def _check_watertight(tris):
    cnt = Counter()
    for t in tris:
        for i in range(3):
            cnt[_edge_key(t[i], t[(i + 1) % 3])] += 1
    bad = {k: v for k, v in cnt.items() if v != 2}
    assert not bad, f"{len(bad)} non-manifold edges of {len(cnt)}"


def test_sphere_watertight_and_oriented():
    c, r = 5.5, 3.2
    x, y, z = _grid(12)
    f = (r ** 2 - ((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2)).astype(
        np.float32)
    tris, normals = _extract(f)
    assert len(tris) > 50
    _check_watertight(tris)
    centers = tris.mean(axis=1)
    centroid = np.array([c, c, c]) / CFG.surface_render_resolution
    dots = (normals * (centers - centroid)).sum(-1)
    assert (dots > 0).mean() > 0.99
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    vol = np.abs((np.cross(v1 - v0, v2 - v0) * v0).sum() / 6.0)
    expect = 4 / 3 * np.pi * (r / CFG.surface_render_resolution) ** 3
    assert abs(vol - expect) / expect < 0.15


def test_random_smooth_field_watertight():
    tris, _ = _extract(_smooth_random())
    assert len(tris) > 20
    _check_watertight(tris)


def test_alpha_interpolation_position():
    zplane = 3.25
    _, _, z = _grid(8)
    tris, _ = _extract((zplane - z).astype(np.float32))
    assert len(tris) > 0
    np.testing.assert_allclose(
        tris[..., 2].ravel(), (0.5 + zplane) / CFG.surface_render_resolution,
        atol=1e-5)


def test_empty_and_full_fields():
    for fill in (-1.0, 1.0):
        tris, _ = _extract(np.full((10, 10, 10), fill, dtype=np.float32))
        assert len(tris) == 0
