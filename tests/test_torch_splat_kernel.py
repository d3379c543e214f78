"""The facade's splat kernel (`tpu_fluid_torch/kernels/splat.py`,
`csrc/splat.cu`): its route, its wrapper's checks, the footprint it walks,
and the order-independence it leans on, on the CPU; on a CUDA card only
(marked `cuda`; they skip without one), the kernel's frame against the
plain version's, bitwise, with the lattices the kernel samples itself
from the triangle tables counted against the plain passes, and no host
sync in the frame's lattice and scatter spans.

The kernel draws every sample of a frame in one stream, in no fixed order,
by atomics.  Its plain counterpart is one scatter-min and one scatter-max
a pass; `test_one_stream_frame_equals_per_pass_frame` holds the two orders
equal on scenes with depth ties, particles behind the surface, samples off
screen and NaN, infinite and huge coordinates."""

import numpy as np
import pytest
import splat_cases
import torch

from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.kernels import splat as splat_kernel
from tpu_fluid_torch.kernels.splat import (COUNTS, footprint,
                                           splat_frame_cuda,
                                           splat_frame_plain)
from tpu_fluid_torch.render import splat
from tpu_fluid_torch.render.camera import Camera
from tpu_fluid_torch.surface.marching_cubes import extract_surface
from tpu_fluid_torch.utils import profiling

torch.set_num_threads(2)

CFG = FluidConfig(grid_size=(12, 12, 12), surface_render_resolution=2)
CAMERA = Camera.for_scene((12, 12, 12))


def _mesh():
    n = 24
    x, y, z = np.meshgrid(*[np.arange(n)] * 3, indexing="ij")
    field = (40 - ((x - 11.3) ** 2 + (y - 12.9) ** 2
                   + (z - 10.1) ** 2)).astype(np.float32)
    return extract_surface(torch.from_numpy(field), CFG, 4096)


def _particles(seed: int, n: int = 2000):
    """Particles in and around the sphere (some behind its surface), a
    quarter inactive, copies of a few (depth ties), some behind the camera
    or far off screen, and NaN, infinite and huge coordinates."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(1, 11, (n, 3)).astype(np.float32)
    pos[:50] = pos[50:100]                             # exact depth ties
    pos[100:110] = CAMERA.position - 2.0 * np.asarray(
        CAMERA.direction, np.float32)                   # behind the camera
    pos[110:120] = rng.uniform(-300, 300, (10, 3))      # off screen
    for k, v in enumerate((np.nan, np.inf, -np.inf, 1e30, -1e30)):
        for axis in range(3):
            pos[120 + 3 * k + axis] = 5.0
            pos[120 + 3 * k + axis, axis] = v
    act = rng.random(n) < 0.75
    act[:135] = True
    return torch.from_numpy(pos), torch.from_numpy(act)


def _scene(seed: int, w: int, h: int, surface: bool = True):
    """(positions, active, mvp, mesh, surface, lattice): `surface` the
    kernel's (tris, normals, tables), `lattice` the plain passes of the
    same tables; (None, None, []) and [] without the surface."""
    pos, act = _particles(seed)
    mvp = torch.from_numpy(CAMERA.mvp().astype(np.float32))
    mesh = _mesh()
    if not surface:
        return pos, act, mvp, mesh, (None, None, []), []
    tables = splat.surface_tables(mesh.vertices, mesh.valid, mvp, w, h)
    lattice = splat.lattice_passes(mesh.vertices, mesh.normals, tables, mvp,
                                   CFG, w, h)
    return pos, act, mvp, mesh, (mesh.vertices, mesh.normals, tables), \
        lattice


SCENES = [  # (seed, width, height, surface, particle_radius)
    (0, 96, 96, True, None), (1, 61, 47, True, None),
    (2, 80, 120, False, None), (3, 64, 64, True, 2), (4, 33, 51, True, 0)]


# ------------------------------------------------------------------ route
def test_render_on_cpu_takes_the_plain_path():
    pos, act, mvp, mesh, _, _ = _scene(0, 64, 64)
    before = splat_frame_cuda.launches
    got = splat.render_particles_and_surface(
        pos, act, mesh.vertices, mesh.normals, mesh.valid, mvp, CFG, 64, 64)
    off = splat.render_particles_and_surface(
        pos, act, mesh.vertices, mesh.normals, mesh.valid, mvp,
        CFG.replace(pallas_mode="off"), 64, 64)
    assert torch.equal(got, off) and (got.numpy() != 0).any()
    assert splat_frame_cuda.launches == before


def test_render_with_kernels_on_and_cpu_tensors_raises():
    pos, act, mvp, mesh, _, _ = _scene(0, 32, 32)
    with pytest.raises(RuntimeError):
        splat.render_particles_and_surface(
            pos, act, mesh.vertices, mesh.normals, mesh.valid, mvp,
            CFG.replace(pallas_mode="on"), 32, 32)


@pytest.mark.parametrize("scene", range(len(SCENES)))
def test_wrapper_on_cpu_runs_plain_version_without_launch(scene):
    seed, w, h, surface, radius = SCENES[scene]
    pos, act, mvp, mesh, surf, lattice = _scene(seed, w, h, surface)
    before = splat_frame_cuda.launches
    got = splat_frame_cuda(pos, act, mvp, *surf, CFG, w, h,
                           particle_radius=radius)
    want = splat_frame_plain(pos, act, mvp, lattice, CFG, w, h,
                             particle_radius=radius)
    assert torch.equal(got, want)
    assert splat_frame_cuda.launches == before
    if surface:
        frame = splat.render_particles_and_surface(
            pos, act, mesh.vertices, mesh.normals, mesh.valid, mvp, CFG, w,
            h, particle_radius=radius)
        assert torch.equal(frame, want)


def _bad_calls():
    pos, act, mvp, _, (tris, normals, tables), _ = _scene(0, 32, 32)
    meta = torch.device("meta")
    ids, valid, subdiv = tables[1]
    surf = (tris, normals, tables)

    def table(k, one):
        return (tris, normals, tables[:k] + [one] + tables[k + 1:])

    return [
        (TypeError, (pos.double(), act, mvp, *surf), {}),
        (ValueError, (pos[:, :2].contiguous(), act, mvp, *surf), {}),
        (ValueError, (pos.T.contiguous().T, act, mvp, *surf), {}),
        (TypeError, (pos, act.to(torch.uint8), mvp, *surf), {}),
        (ValueError, (pos, act[:-1], mvp, *surf), {}),
        (ValueError, (pos, act.to(meta), mvp, *surf), {}),
        (TypeError, (pos, act, mvp.double(), *surf), {}),
        (ValueError, (pos, act, mvp[:3].contiguous(), *surf), {}),
        (ValueError, (pos, act, mvp.T, *surf), {}),
        (TypeError, (pos, act, mvp, tris.double(), normals, tables), {}),
        (ValueError, (pos, act, mvp,
                      *table(0, (None, tables[0][1][:-1], 4))), {}),
        (TypeError, (pos, act, mvp,
                     *table(1, (ids, valid.to(torch.uint8), subdiv))), {}),
        (ValueError, (pos, act, mvp, tris, normals[:, :2], tables), {}),
        (ValueError, (pos, act, mvp,
                      *table(1, (ids.to(meta), valid, subdiv))), {}),
        (ValueError, (pos, act, mvp,
                      *table(1, (ids, valid.repeat(2)[::2], subdiv))), {}),
        (ValueError, (pos, act, mvp, tris, normals, tables + tables[:1]),
         {}),
        (ValueError, (pos, act, mvp, *surf), {"width": 0}),
        (ValueError, (pos, act, mvp, *surf), {"height": 32.0}),
        (ValueError, (pos, act, mvp, *surf),
         {"counts": torch.zeros(len(COUNTS), dtype=torch.int64)}),
        (TypeError, (pos, act, mvp,
                     *table(2, (ids.to(torch.int32), valid, 24))), {}),
        (ValueError, (pos, act, mvp, *table(1, (ids, valid, 0))), {}),
        (ValueError, (pos, act, mvp, tris[:, :2].contiguous(), normals,
                      tables), {}),
        (ValueError, (pos, act, mvp, None, None, tables), {}),
    ]


N_BAD = 23


def test_bad_calls_are_all_tried():
    assert len(_bad_calls()) == N_BAD


@pytest.mark.parametrize("case", range(N_BAD))
def test_wrapper_rejects_bad_inputs_before_any_launch(case, monkeypatch):
    error, args, kw = _bad_calls()[case]
    kw = {"width": 32, "height": 32, **kw}
    launched = []
    monkeypatch.setattr(splat_kernel.build, "call",
                        lambda *a: launched.append(a))
    with pytest.raises(error):
        splat_frame_cuda(*args, CFG, kw.pop("width"), kw.pop("height"),
                         **kw)
    assert not launched


# -------------------------------------------------------------- footprint
def _plain_offsets(particle_radius, max_sprite_radius):
    """The (dx, dy) of each sprite pass the plain loop makes, read off the
    passes of one particle at an integral pixel."""
    mvp = torch.eye(4)
    pos = torch.tensor([[0.25, 0.5, 0.0]])          # pixel (80, 96) of 128^2
    px, py, _, _ = splat.project(mvp, pos, 128, 128)
    passes = splat.sprite_passes(pos, torch.ones(1, dtype=torch.bool), mvp,
                                 CFG, 128, 128, particle_radius,
                                 max_sprite_radius)
    return [(int(p[0][0] - px[0]), int(p[1][0] - py[0])) for p in passes]


@pytest.mark.parametrize("radius, rmax", [(None, r) for r in range(5)]
                         + [(r, 3) for r in range(4)] + [(2, 0)])
def test_footprint_is_the_plain_loops_passes(radius, rmax):
    walk = footprint(radius, rmax)
    plain = _plain_offsets(radius, rmax)
    assert len(plain) == len(set(plain)) == len(walk)
    assert sorted(walk) == sorted(plain)
    # the centre first, then nearest first: the lit offsets of any sprite
    # are a prefix of the walk
    assert walk[0] == (0, 0)
    dist = [dx * dx + dy * dy for dx, dy in walk]
    assert dist == sorted(dist)
    for r2 in (0.25, 1.0, 1.5, 2.0, 4.0, 6.25, 9.0, float("nan")):
        lit = [o for o, q in zip(walk, dist) if q == 0 or q <= r2]
        assert lit == list(walk[:len(lit)])


# ------------------------------------------------------ order independence
def _draw_one_stream(passes, w, h, order=None):
    """All passes' samples in one scatter-min and one scatter-max."""
    px, py, d, valid, col = (torch.cat(parts) for parts in zip(*passes))
    if order is not None:
        px, py, d, valid, col = (t[order] for t in (px, py, d, valid, col))
    return splat.draw_passes([(px, py, d, valid, col)], w, h, CFG,
                             torch.device("cpu"))


@pytest.mark.parametrize("scene", range(len(SCENES)))
def test_one_stream_frame_equals_per_pass_frame(scene):
    seed, w, h, surface, radius = SCENES[scene]
    pos, act, mvp, _, _, lattice = _scene(seed, w, h, surface)
    passes = lattice + splat.sprite_passes(pos, act, mvp, CFG, w, h, radius)
    want = splat.draw_passes(passes, w, h, CFG, torch.device("cpu"))
    # the scene holds what the kernel has to get right
    px, py, d, front = splat.project(mvp, pos, w, h)
    assert (front & ~torch.isfinite(px)).any()      # NaN at pixel 0
    assert (~front).any() and (front & (px < 0)).any()
    assert (want.numpy() != 0).any()
    total = sum(p[0].shape[0] for p in passes)
    order = torch.randperm(total, generator=torch.Generator().manual_seed(
        seed))
    assert torch.equal(_draw_one_stream(passes, w, h), want)
    assert torch.equal(_draw_one_stream(passes, w, h, order), want)
    assert torch.equal(_draw_one_stream(passes, w, h, order.flip(0)), want)


# ---------------------------------------------------------------- on card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are compiled and run "
                    "only there")
    return torch.device("cuda", 0)


def _kernel_and_plain(pos, act, mvp, tris, normals, tables, w, h,
                      radius=None):
    """The kernel's frame, the counting instantiation's frame and counts,
    the plain frame of the same tables, and the plain passes' samples."""
    lattice = ([] if tris is None else splat.lattice_passes(
        tris, normals, tables, mvp, CFG, w, h))
    before = splat_frame_cuda.launches
    got = splat_frame_cuda(pos, act, mvp, tris, normals, tables, CFG, w, h,
                           particle_radius=radius)
    want = splat_frame_plain(pos, act, mvp, lattice, CFG, w, h,
                             particle_radius=radius)
    counts = torch.zeros(len(COUNTS), dtype=torch.int64, device=pos.device)
    counted = splat_frame_cuda(pos, act, mvp, tris, normals, tables, CFG, w,
                               h, particle_radius=radius, counts=counts)
    torch.cuda.synchronize()
    assert splat_frame_cuda.launches == before + 2
    return (got, counted, want, dict(zip(COUNTS, counts.tolist())),
            sum(p[0].shape[0] for p in lattice))


@pytest.mark.cuda
@pytest.mark.parametrize("scene", range(len(SCENES)))
def test_cuda_splat_matches_plain_bitwise(cuda_device, scene):
    seed, w, h, surface, radius = SCENES[scene]
    pos, act, mvp, mesh, _, _ = _scene(seed, w, h, False)
    pos, act, mvp = (t.to(cuda_device) for t in (pos, act, mvp))
    # the tables made on the card, as the frame makes them
    tris, normals, valid = (t.to(cuda_device) for t in (
        mesh.vertices, mesh.normals, mesh.valid))
    tables = splat.surface_tables(tris, valid, mvp, w, h) if surface else []
    if not surface:
        tris = normals = None
    got, counted, want, c, samples = _kernel_and_plain(
        pos, act, mvp, tris, normals, tables, w, h, radius)
    assert torch.equal(got, want) and torch.equal(counted, want)
    assert 0 < c["depth_atomics"] <= c["depth_tested"]
    assert c["color_tested"] == c["depth_tested"]
    assert 0 < c["color_atomics"] <= c["color_won"] <= c["color_tested"]
    assert c["lattice_samples"] == samples and (samples > 0) == surface


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(splat_cases.SURFACES))
@pytest.mark.parametrize("size", [splat_cases.SIZE, (61, 47)])
def test_cuda_lattice_cases_match_plain_bitwise(cuda_device, case, size):
    """The kernel's own lattice samples on the lattice corner cases: no
    valid triangle, every slot valid, a budget cut among tied extents,
    vertices behind the camera, NaN normals, NaN and infinite vertices."""
    tris, normals, valid, cam, budget = splat_cases.surface(case)
    pos, act = splat_cases.particles()
    w, h = size
    pos, act, tris, normals, valid = (
        torch.from_numpy(a).to(cuda_device)
        for a in (pos, act, tris, normals, valid))
    mvp = torch.from_numpy(cam.mvp().astype(np.float32)).to(cuda_device)
    tables = splat.surface_tables(tris, valid, mvp, w, h,
                                  fine_tri_budget=budget)
    got, counted, want, c, samples = _kernel_and_plain(
        pos, act, mvp, tris, normals, tables, w, h)
    assert torch.equal(got, want) and torch.equal(counted, want)
    assert c["lattice_samples"] == samples
    assert (samples == 0) == (case == "no_valid")


@pytest.mark.cuda
def test_cuda_frame_lattice_and_scatter_spans_make_no_host_sync(cuda_device):
    pos, act, mvp, mesh, _, _ = _scene(0, 96, 96)
    args = [t.to(cuda_device) for t in (pos, act, mesh.vertices,
                                        mesh.normals, mesh.valid, mvp)]

    def frame():
        return splat.render_particles_and_surface(*args, CFG, 96, 96)

    want = frame()                      # the library and offsets, once
    before = splat_frame_cuda.launches
    profiling.tracing(True)
    try:
        profiling.reset()
        got = frame()
        rep = profiling.report()
    finally:
        profiling.tracing(False)
        profiling.reset()
    assert splat_frame_cuda.launches == before + 1
    assert torch.equal(got, want)
    for name in ("splat.surface_lattice", "splat.scatter"):
        assert rep[name]["calls"] == 1 and rep[name]["syncs"] == 0, rep
