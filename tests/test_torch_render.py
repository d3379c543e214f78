"""Rendering of the PyTorch port (`tpu_fluid_torch/render/`,
`tpu_fluid_torch/native/`) against the JAX package's, and mirrors of
tests/test_render_splat.py and tests/test_native_raster.py.

The splat frames are held against JAX's jitted frame (the program the JAX
engine runs) pixel for pixel: the port computes the projection, the
shading and the lattice in XLA:CPU's order (`render/splat.py`), and every
frame below is bitwise equal (share of equal pixels 1.0).  The cell-field
frame takes a logarithm, which XLA and PyTorch round differently, so it is
held to a share of at least 99.9% of equal pixels (measured: 1.0).  The
native frame is the same C++ on the same numpy inputs: bitwise."""

import shutil

import numpy as np
import pytest
import torch

from tpu_fluid.core.config import FluidConfig as JaxConfig
from tpu_fluid.render import camera as jax_camera
from tpu_fluid.render import splat as jax_splat
from tpu_fluid.render.debug import render_cell_field as jax_cell_field
from tpu_fluid.surface.marching_cubes import extract_surface as jax_extract
from tpu_fluid_torch import native
from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.render import camera as port_camera
from tpu_fluid_torch.render import splat
from tpu_fluid_torch.render.camera import Camera
from tpu_fluid_torch.render.debug import render_cell_field
from tpu_fluid_torch.render.export import write_png
from tpu_fluid_torch.render.raster import render_frame_native
from tpu_fluid_torch.render.splat import render_particles_and_surface
from tpu_fluid_torch.surface.marching_cubes import extract_surface

torch.set_num_threads(2)

KW = dict(grid_size=(12, 12, 12), surface_render_resolution=2)


def jnp():
    import jax.numpy
    return jax.numpy


def equal_share(a, b) -> float:
    return float((np.asarray(a) == np.asarray(b)).all(-1).mean())


# ------------------------------------------------------------ camera, copy
def test_camera_matrices_equal_jax():
    for make in (lambda m: m.Camera(),
                 lambda m: m.Camera.for_scene((12, 12, 12)),
                 lambda m: m.Camera.for_scene((64, 32, 16)),
                 lambda m: m.Camera(position=(3.0, 7.0, -9.0)).orbit(
                     73.0, (10.0, 10.0, 10.0)),
                 lambda m: m.Camera().move((1.0, -2.0, 0.5)).look_at_point(
                     (6.0, 6.0, 6.0))):
        got, want = make(port_camera), make(jax_camera)
        for name in ("view", "projection", "mvp"):
            g, w = getattr(got, name)(), getattr(want, name)()
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_rasterizer_source_is_a_copy():
    from pathlib import Path
    jax_src = Path(__file__).resolve().parent.parent / "tpu_fluid" / \
        "native" / "rasterizer.cpp"
    assert native.SOURCE.read_bytes() == jax_src.read_bytes()


# ------------------------------------------------------------- projection
@pytest.mark.parametrize("n", [1, 2, 7, 100, 4000])
def test_project_matches_jax(n):
    import jax
    rng = np.random.default_rng(n)
    pts = rng.uniform(-4, 16, (n, 3)).astype(np.float32)
    mvp = Camera.for_scene((12, 12, 12)).mvp()
    got = splat.project(torch.from_numpy(mvp), torch.from_numpy(pts), 128,
                        96)
    for fn in (jax_splat.project,
               jax.jit(jax_splat.project, static_argnums=(2, 3))):
        want = fn(jnp().asarray(mvp), jnp().asarray(pts), 128, 96)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------- top-k ties
@pytest.mark.parametrize("k", [1, 3, 5, 9])
def test_top_extents_ties_match_jax_top_k(k):
    import jax
    ext = np.array([2.0, 7.5, -1.0, 7.5, 2.0, -1.0, 7.5, 0.5, 2.0],
                   np.float32)
    vals, ids = splat.top_extents(torch.from_numpy(ext), k)
    jv, ji = jax.lax.top_k(jnp().asarray(ext), k)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))


# ----------------------------------------------------------- splat frames
def _sphere_field(n=24):
    x, y, z = np.meshgrid(*[np.arange(n)] * 3, indexing="ij")
    return (40 - ((x - 11.3) ** 2 + (y - 12.9) ** 2
                  + (z - 10.1) ** 2)).astype(np.float32)


def _meshes(field, max_cells=4096):
    import jax
    jmesh = jax.jit(jax_extract, static_argnums=(1, 2))(
        jnp().asarray(field), JaxConfig(**KW), max_cells)
    return jmesh, extract_surface(torch.from_numpy(field),
                                  FluidConfig(**KW), max_cells)


def _particles(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(2, 10, (n, 3)).astype(np.float32),
            rng.random(n) < 0.8)


FRAMES = {
    # (width, height, camera, fine_tri_budget, particle_radius)
    "default": (128, 128, Camera.for_scene((12, 12, 12)), 65536, None),
    "close_small_budget": (96, 64, Camera(position=(6.0, 6.0, -1.0))
                           .look_at_point((6.0, 6.0, 6.0)), 8, None),
    "fixed_radius": (80, 80, Camera.for_scene((12, 12, 12)), 65536, 2),
}


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_render_matches_jitted_jax(frame):
    w, h, cam, budget, radius = FRAMES[frame]
    jmesh, mesh = _meshes(_sphere_field())
    pos, act = _particles()
    want = jax_splat.render_particles_and_surface_jit(
        jnp().asarray(pos), jnp().asarray(act), jmesh.vertices,
        jmesh.normals, jmesh.valid, cam.mvp(), cfg=JaxConfig(**KW),
        width=w, height=h, fine_tri_budget=budget, particle_radius=radius)
    got = render_particles_and_surface(
        torch.from_numpy(pos), torch.from_numpy(act), mesh.vertices,
        mesh.normals, mesh.valid, cam.mvp(), FluidConfig(**KW), w, h,
        fine_tri_budget=budget, particle_radius=radius)
    assert got.dtype == torch.uint8 and got.shape == (h, w, 3)
    assert (got.numpy() != 0).any()
    assert equal_share(got.numpy(), want) == 1.0


def test_refinement_ties_match_jax():
    """Copies of one triangle side by side project to equal extents; with
    a budget below their number the refinement takes the lower indices
    first, as jax.lax.top_k."""
    base = np.array([[5.0, 5.0, 4.0], [7.0, 5.0, 4.0], [6.0, 7.0, 4.0]],
                    np.float32)
    tris = np.stack([base + np.array([dx, 0.0, 0.0], np.float32)
                     for dx in (-4.0, -2.0, 0.0, 2.0, 4.0)])
    normals = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (5, 1))
    valid = np.ones(5, bool)
    cam = Camera(position=(6.0, 6.0, -2.0)).look_at_point((6.0, 6.0, 6.0))
    pos = np.full((1, 3), -100.0, np.float32)
    act = np.zeros(1, bool)
    want = jax_splat.render_particles_and_surface_jit(
        jnp().asarray(pos), jnp().asarray(act), jnp().asarray(tris),
        jnp().asarray(normals), jnp().asarray(valid), cam.mvp(),
        cfg=JaxConfig(**KW), width=128, height=128, fine_tri_budget=8)
    got = render_particles_and_surface(
        torch.from_numpy(pos), torch.from_numpy(act), torch.from_numpy(tris),
        torch.from_numpy(normals), torch.from_numpy(valid), cam.mvp(),
        FluidConfig(**KW), 128, 128, fine_tri_budget=8)
    assert equal_share(got.numpy(), want) == 1.0


@pytest.mark.parametrize("log_scale", [True, False])
def test_render_cell_field_matches_jax(log_scale):
    rng = np.random.default_rng(5)
    field = np.where(rng.random((12, 12, 12)) < 0.5, 0.0,
                     rng.uniform(0, 40, (12, 12, 12))).astype(np.float32)
    mvp = Camera.for_scene((12, 12, 12)).mvp()
    want = jax_cell_field(jnp().asarray(field), mvp, JaxConfig(**KW), 96,
                          96, log_scale=log_scale)
    got = render_cell_field(torch.from_numpy(field), mvp, FluidConfig(**KW),
                            96, 96, log_scale=log_scale)
    assert got.dtype == torch.uint8 and got.shape == (96, 96, 3)
    assert (got.numpy() != 0).any()
    assert equal_share(got.numpy(), want) >= 0.999


# -------------------------------------------------------------------- PNG
@pytest.mark.parametrize("shape", [(1, 1), (37, 53), (64, 64)])
def test_png_reads_back_with_pil(tmp_path, shape):
    from PIL import Image
    img = np.random.default_rng(1).integers(0, 256, shape + (3,),
                                            dtype=np.uint8)
    path = str(tmp_path / "sub" / "f.png")
    write_png(path, torch.from_numpy(img))
    with Image.open(path) as back:
        assert back.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(back), img)


def test_png_refuses_other_shapes(tmp_path):
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "g.png"), np.zeros((4, 4), np.uint8))


# ------------------------------------- mirrors of test_render_splat.py
def _cfg():
    return FluidConfig.reference_scene().replace(
        particle_count=8, particle_init_cube_resolution=(2, 2, 2))


def _red_pixels(img):
    img = img.numpy()
    return (img[..., 0] > 200) & (img[..., 1] < 50)


def _t(a, dtype=torch.float32):
    return torch.tensor(a, dtype=dtype)


def test_sprite_size_scales_with_depth():
    positions = _t([[9.9, 10.0, -9.0], [11.0, 10.0, 30.0]])
    active = _t([True, True], torch.bool)
    img = render_particles_and_surface(positions, active, None, None, None,
                                       Camera().mvp(), _cfg(), 512, 512)
    red = _red_pixels(img)
    ys, xs = np.nonzero(red)
    assert red.sum() > 0
    mid = (xs.min() + xs.max()) / 2.0
    near_area = int((xs < mid).sum())
    far_area = int((xs >= mid).sum())
    assert near_area > 0 and far_area > 0
    assert near_area > 2 * far_area


def test_fixed_radius_still_supported():
    img = render_particles_and_surface(
        _t([[10.0, 10.0, 5.0]]), _t([True], torch.bool), None, None, None,
        Camera().mvp(), _cfg(), 256, 256, particle_radius=2)
    assert _red_pixels(img).sum() >= 9


TRI = [[[9.5, 9.5, 10.0], [10.5, 9.5, 10.0], [10.0, 10.5, 10.0]]]


def _covered(img, cfg):
    bg = (np.asarray(cfg.background_color) * 255).astype(np.uint8)
    return ~np.all(img.numpy() == bg, axis=-1)


def test_large_triangle_has_no_interior_holes():
    cfg = _cfg()
    img = render_particles_and_surface(
        torch.zeros((1, 3)) - 100.0, _t([False], torch.bool), _t(TRI),
        _t([[0.0, 0.0, -1.0]]), _t([True], torch.bool), Camera().mvp(), cfg,
        256, 256)
    covered = _covered(img, cfg)
    ys, xs = np.nonzero(covered)
    assert covered.sum() > 60
    cy, cx = int(ys.mean()), int(xs.mean())
    assert covered[cy - 2:cy + 3, cx - 2:cx + 3].all()


def test_base_lattice_alone_leaves_holes_in_same_triangle():
    cfg = _cfg()
    args = (torch.zeros((1, 3)) - 100.0, _t([False], torch.bool), _t(TRI),
            _t([[0.0, 0.0, -1.0]]), _t([True], torch.bool), Camera().mvp(),
            cfg, 256, 256)
    img = render_particles_and_surface(*args, surface_subdiv=3,
                                       fine_tri_budget=1)
    img_adaptive = render_particles_and_surface(*args)
    assert _covered(img_adaptive, cfg).sum() >= _covered(img, cfg).sum()


def test_orbit_preserves_distance_and_aims_at_center():
    cam = Camera(position=(10.0, 10.0, -10.0))
    center = (10.0, 10.0, 10.0)
    r0 = np.linalg.norm(np.asarray(cam.position) - center)
    for ang in (45.0, 90.0, 180.0):
        c2 = cam.orbit(ang, center)
        assert np.isclose(np.linalg.norm(np.asarray(c2.position) - center),
                          r0)
        d = np.asarray(c2.direction)
        want = center - np.asarray(c2.position)
        assert d @ want / (np.linalg.norm(d) * np.linalg.norm(want)) > 0.9999
    assert np.isclose(cam.orbit(73.0, center).position[1], 10.0)


def test_orbit_full_circle_returns():
    cam = Camera(position=(3.0, 7.0, -9.0))
    out = cam
    for _ in range(8):
        out = out.orbit(45.0, (10.0, 10.0, 10.0))
    assert np.allclose(out.position, (3.0, 7.0, -9.0), atol=1e-9)


# ------------------------------------ mirrors of test_native_raster.py
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no C++ toolchain")
NCFG = FluidConfig(grid_size=(20, 20, 20))


@needs_gxx
def test_triangle_visible_and_shaded():
    tris = np.array([[[5, 5, 5], [15, 5, 5], [10, 15, 5]]], dtype=np.float32)
    n = np.array([[0, 0, -1]], dtype=np.float32)
    img = render_frame_native(None, None, tris, n, Camera().mvp(), NCFG,
                              256, 256)
    assert img.shape == (256, 256, 3)
    hit = (img != 0).any(axis=-1)
    assert hit.sum() > 100
    assert (img[..., 2][hit] > 0).all()


@needs_gxx
def test_particles_sprite_size_grows_with_proximity():
    cfg = NCFG.replace(particle_render_size=120.0,
                       particle_render_max_size=40.0)
    act = np.ones(1, dtype=bool)
    img_near = render_frame_native(np.array([[10.0, 10.0, 2.0]], np.float32),
                                   act, None, None, Camera().mvp(), cfg, 256,
                                   256)
    img_far = render_frame_native(np.array([[10.0, 10.0, 18.0]], np.float32),
                                  act, None, None, Camera().mvp(), cfg, 256,
                                  256)
    assert (img_near[..., 0] > 0).sum() > (img_far[..., 0] > 0).sum() > 0


@needs_gxx
def test_depth_test_particle_behind_triangle():
    tris = np.array([[[0, 0, 10], [20, 0, 10], [10, 20, 10]]],
                    dtype=np.float32)
    n = np.array([[0, 0, -1]], dtype=np.float32)
    act = np.ones(1, dtype=bool)
    img = render_frame_native(np.array([[10.0, 8.0, 15.0]], np.float32),
                              act, tris, n, Camera().mvp(), NCFG, 256, 256)
    red = (img[..., 0] > 200) & (img[..., 1] < 50) & (img[..., 2] < 50)
    assert red.sum() == 0
    img2 = render_frame_native(np.array([[10.0, 8.0, 5.0]], np.float32),
                               act, tris, n, Camera().mvp(), NCFG, 256, 256)
    assert ((img2[..., 0] > 200) & (img2[..., 1] < 50)).sum() > 0


@needs_gxx
def test_background_color():
    cfg = NCFG.replace(background_color=(0.1, 0.2, 0.3))
    img = render_frame_native(None, None, None, None, Camera().mvp(), cfg,
                              32, 32)
    assert (img[..., 0] == 25).all()
    assert (img[..., 1] == 51).all()
    assert (img[..., 2] == 76).all()


@needs_gxx
def test_native_frame_equals_jax():
    from tpu_fluid.render.raster import render_frame_native as jax_native
    from tpu_fluid.surface.marching_cubes import mesh_to_numpy
    jmesh, _ = _meshes(_sphere_field())
    tris, normals = mesh_to_numpy(jmesh)
    pos, act = _particles()
    mvp = Camera.for_scene((12, 12, 12)).mvp()
    want = jax_native(pos, act, tris, normals, mvp, JaxConfig(**KW), 160,
                      120)
    if want is None:
        pytest.skip("the JAX package's rasterizer did not build")
    got = render_frame_native(pos, act, tris, normals, mvp,
                              FluidConfig(**KW), 160, 120)
    assert (got != 0).any()
    np.testing.assert_array_equal(got, want)


def test_native_build_failure_raises_with_compiler_output(tmp_path,
                                                          monkeypatch):
    """No fallback: a source that does not compile raises with g++'s
    output (or says that g++ is missing)."""
    bad = tmp_path / "rasterizer.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "build" / "lib.so")
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.build_library()


@needs_gxx
@pytest.mark.parametrize("case", ["active_length", "tris_shape"])
def test_native_refuses_mismatched_inputs(case):
    """The host arrays' shapes are checked before their pointers reach the
    library."""
    pos = np.zeros((4, 3), np.float32)
    act = np.ones(3 if case == "active_length" else 4, bool)
    tris = np.zeros((2, 3, 3) if case == "active_length" else (2, 9),
                    np.float32)
    with pytest.raises(ValueError):
        render_frame_native(pos, act, tris, np.zeros((2, 3), np.float32),
                            Camera().mvp(), NCFG, 16, 16)
