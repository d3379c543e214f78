"""The level-set kernel's rewritings on the CPU (`kernels/levelset.py`,
`csrc/levelset.cu`), each held bitwise against the plain level set
(`surface/levelset.py`):

- the sweep as the kernel computes it: each weight class's minimum first,
  then its weight once, from the in-plane minima of each plane (its 4 face
  and 4 diagonal neighbours in y-z) shared by three planes, equals
  `chamfer_distance`'s 26 shifted adds and minima;
- the dead-box rule: a cell with no occupied cell within sweeps + smooth
  cells (a plain dilation of the occupancy) holds the constant's smoothing,
  the field of an empty occupancy; the boxes the scan leaves out hold it,
  and those whose smoothing ring lies inside the grid with no SOLID parent
  hold its value at an interior cell, which the kernel writes unmarched;
- the live-box rule and the box geometry;
- the wrapper's refusals, and the plain route for CPU tensors.

The file imports no JAX: its `cuda` test runs on the card against the
plain version."""

import numpy as np
import pytest
import torch

from tpu_fluid_torch import FluidConfig
from tpu_fluid_torch.core.types import CellType
from tpu_fluid_torch.kernels import levelset as kernel
from tpu_fluid_torch.ops.stencil import shifted
from tpu_fluid_torch.stages.surface_fields import update_surface_fields
from tpu_fluid_torch.surface import levelset
from tpu_fluid_torch.utils import profiling

torch.set_num_threads(2)
BIG = levelset._BIG
# (detailed shape, r): odd sizes, a face of 13 cells, r of 1 and 2
SHAPES = (((13, 20, 37), 1), ((26, 40, 74), 2))
OCCUPANCIES = ("sparse", "empty", "full", "faces")


def inputs(shape, r, occupancy, seed=0):
    """(types, occ) of a detailed grid: seeded cell types with SOLID walls
    and a solid box, and an occupancy that is sparse, empty, full, or a few
    cells on every face."""
    rng = np.random.default_rng(seed)
    sim = tuple(s // r for s in shape)
    types = rng.integers(0, 3, sim).astype(np.uint8)
    for ax in range(3):
        idx = [slice(None)] * 3
        for end in (0, -1):
            idx[ax] = end
            types[tuple(idx)] = CellType.SOLID
    types[1:3, 2:4, 1:3] = CellType.SOLID
    occ = np.zeros(shape, np.uint8)
    if occupancy == "sparse":
        occ = ((rng.random(shape) < 0.004)
               * rng.integers(1, 4, shape)).astype(np.uint8)
    elif occupancy == "full":
        occ[:] = 1
    elif occupancy == "faces":
        for at in ((0, 3, 4), (-1, 1, 2), (2, 0, 1), (1, -1, 3), (3, 2, 0),
                   (4, 1, -1)):
            occ[at] = 5
    return torch.from_numpy(types), torch.from_numpy(occ)


def config(shape, r, sweeps, smooth):
    return FluidConfig(grid_size=tuple(s // r for s in shape),
                       surface_render_resolution=r, surface_method="levelset",
                       levelset_iso=1.3, levelset_sweeps=sweeps,
                       levelset_smooth=smooth)


def bits(t):
    return t.contiguous().view(torch.int32)


def chamfer_by_planes(occ, sweeps):
    """The kernel's sweeps: the in-plane minima F (faces) and E
    (diagonals) of every plane, then for each plane between its two
    neighbours faces min(phi[x-1], phi[x+1], F[x]) + 1, edges min(E[x],
    F[x-1], F[x+1]) + sqrt 2, corners min(E[x-1], E[x+1]) + sqrt 3, kBig
    outside the grid."""
    _, w2, w3, _ = kernel.constants(config(occ.shape, 1, sweeps, 0))
    phi = torch.full(occ.shape, BIG, dtype=torch.float32)
    phi.masked_fill_(occ != 0, 0.0)

    def lo(*a):
        out = a[0]
        for b in a[1:]:
            out = torch.minimum(out, b)
        return out

    def at(a, dx, dy=0, dz=0):
        return shifted(a, (dx, dy, dz), fill=BIG)

    for _ in range(sweeps):
        f = lo(at(phi, 0, 1), at(phi, 0, -1), at(phi, 0, 0, 1),
               at(phi, 0, 0, -1))
        e = lo(at(phi, 0, 1, 1), at(phi, 0, 1, -1), at(phi, 0, -1, 1),
               at(phi, 0, -1, -1))
        faces = lo(at(phi, -1), at(phi, 1), f)
        edges = lo(e, at(f, -1), at(f, 1))
        corners = lo(at(e, -1), at(e, 1))
        phi = lo(phi, faces + 1.0, edges + w2, corners + w3)
    return phi


@pytest.mark.parametrize("sweeps", range(1, 7))
@pytest.mark.parametrize("occupancy", OCCUPANCIES)
@pytest.mark.parametrize("shape,r", SHAPES, ids=["13x20x37", "26x40x74"])
def test_class_minima_from_shared_plane_minima_equal_the_sweeps(
        shape, r, occupancy, sweeps):
    _, occ = inputs(shape, r, occupancy, seed=sweeps)
    want = levelset.chamfer_distance(occ, sweeps)
    assert torch.equal(bits(chamfer_by_planes(occ, sweeps)), bits(want))


def dead_cells(occ, ring):
    return ~kernel.dilate(occ, ring)


@pytest.mark.parametrize("sweeps,smooth", [(s, m) for s in range(1, 7)
                                           for m in range(4)])
def test_dead_cells_hold_the_constants_smoothing(sweeps, smooth):
    """Where no occupied cell lies within sweeps + smooth cells, the field
    is the one an empty occupancy gives, bitwise; and some such cells lie
    beside occupied ones' reach, so the rule is tight."""
    shape, r = SHAPES[1]
    types, occ = inputs(shape, r, "sparse", seed=10 * sweeps + smooth)
    occ[:, :, 40:] = 0  # a region with no water, touching three faces
    cfg = config(shape, r, sweeps, smooth)
    field = levelset.levelset_plain(types, occ, cfg)
    constant = levelset.levelset_plain(types, torch.zeros_like(occ), cfg)
    dead = dead_cells(occ, sweeps + smooth)
    assert 0 < int(dead.sum()) < occ.numel()
    assert torch.equal(bits(field[dead]), bits(constant[dead]))
    # one cell closer and the rule would be wrong somewhere
    near = dead_cells(occ, sweeps + smooth - 1) & ~dead
    assert bool((bits(field[near]) != bits(constant[near])).any())


@pytest.mark.parametrize("occupancy", OCCUPANCIES)
@pytest.mark.parametrize("shape,r", SHAPES, ids=["13x20x37", "26x40x74"])
def test_dead_cells_hold_the_constants_smoothing_at_every_occupancy(
        shape, r, occupancy):
    types, occ = inputs(shape, r, occupancy, seed=3)
    cfg = config(shape, r, 4, 2)
    field = levelset.levelset_plain(types, occ, cfg)
    constant = levelset.levelset_plain(types, torch.zeros_like(occ), cfg)
    dead = dead_cells(occ, 6)
    assert torch.equal(bits(field[dead]), bits(constant[dead]))


def interior_value(cfg):
    """The kernel's value of a filled box: the constant's smoothing at a
    cell with every neighbour in the grid and no SOLID parent, six adds of
    the value in MOVES order a pass."""
    iso, _, _, c7 = kernel.constants(cfg)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    g = f32(iso) - torch.clamp(f32(BIG), max=cfg.levelset_sweeps_value + 1.0)
    for _ in range(cfg.levelset_smooth):
        s = f32(0.0) + g
        for _ in range(5):
            s = s + g
        g = (g + s) * f32(c7)
    return g


def box_flags(p, types, occ, smooth, r):
    """The scan's flag of each box of plan `p`: 1 live, else 2 where the
    box with its `smooth` ring lies inside the grid with no cell under a
    SOLID parent, else 0."""
    live = set(kernel.live_boxes(p, occ))
    solid = types == CellType.SOLID
    for ax in range(3):
        solid = torch.repeat_interleave(solid, r, dim=ax)
    flags = []
    for i, box in enumerate(p.boxes()):
        grown = [(lo - smooth, hi + smooth) for lo, hi in box]
        inside = all(lo >= 0 and hi <= n
                     for (lo, hi), n in zip(grown, occ.shape))
        plain = inside and not bool(
            solid[tuple(slice(lo, hi) for lo, hi in grown)].any())
        flags.append(1 if i in live else (2 if plain else 0))
    return flags


@pytest.mark.parametrize("sweeps,smooth", [(1, 0), (2, 1), (4, 2), (3, 3),
                                           (5, 3)])
def test_the_boxes_the_scan_leaves_out_hold_the_constant(sweeps, smooth):
    """On a grid with dead boxes of both kinds: every box the scan leaves
    out holds the empty occupancy's field, and a filled box holds its
    interior value in every cell."""
    shape, r = (100, 96, 96), 2
    types, occ = inputs(shape, r, "empty", seed=sweeps)
    occ[20:30, 40:52, 40:47] = torch.from_numpy(
        (np.random.default_rng(sweeps).random((10, 12, 7)) < 0.3)
        .astype(np.uint8))
    cfg = config(shape, r, sweeps, smooth)
    field = levelset.levelset_plain(types, occ, cfg)
    constant = levelset.levelset_plain(types, torch.zeros_like(occ), cfg)
    p = kernel.plan(shape, sweeps, smooth, r)
    flags = box_flags(p, types, occ, smooth, r)
    g = interior_value(cfg)
    assert {0, 1, 2} <= set(flags)
    for flag, box in zip(flags, p.boxes()):
        cells = tuple(slice(lo, hi) for lo, hi in box)
        if flag != 1:
            assert torch.equal(bits(field[cells]), bits(constant[cells]))
        if flag == 2:
            assert torch.equal(bits(field[cells]),
                               bits(g.expand(field[cells].shape)))


@pytest.mark.parametrize("sweeps,smooth", [(0, 0), (4, 2), (6, 2), (0, 8)])
@pytest.mark.parametrize("shape", [(13, 20, 37), (64, 50, 41), (1, 1, 1)])
def test_the_boxes_tile_the_grid_and_the_live_rule_is_plain(shape, sweeps,
                                                            smooth):
    """Each detailed cell lies in exactly one box, in box order (z tiles,
    then y tiles, then segments); a box is live exactly where an occupied
    cell lies within sweeps + smooth cells of it."""
    p = kernel.plan(shape, sweeps, smooth)
    cover = torch.zeros(shape, dtype=torch.int32)
    boxes = list(p.boxes())
    assert len(boxes) == p.total
    for (x0, x1), (y0, y1), (z0, z1) in boxes:
        assert 0 < x1 - x0 <= p.seg and 0 < y1 - y0 <= p.inner
        assert 0 < z1 - z0 <= p.inner
        cover[x0:x1, y0:y1, z0:z1] += 1
    assert bool((cover == 1).all())
    rng = np.random.default_rng(sum(shape))
    occ = torch.from_numpy((rng.random(shape) < 0.001).astype(np.uint8))
    ring = sweeps + smooth
    want = []
    for i, box in enumerate(boxes):
        grown = tuple(slice(max(lo - ring, 0), hi + ring) for lo, hi in box)
        if bool(occ[grown].any()):
            want.append(i)
    assert kernel.live_boxes(p, occ) == want


def test_the_plan_refuses_what_the_kernel_cannot_take(monkeypatch):
    """The plan refuses a halo above MAX_HALO, negative sweeps and more
    than MAX_TILES_Z boxes along z; the stage path, where it picks the
    kernel, raises so for CUDA tensors before any launch, and does not
    take the plain passes instead."""
    with pytest.raises(ValueError, match="sweeps \\+ smooth <= 8"):
        kernel.plan((16, 16, 16), 7, 2)
    with pytest.raises(ValueError, match="sweeps"):
        kernel.plan((16, 16, 16), -1, 2)
    with pytest.raises(ValueError, match="boxes along z"):
        kernel.plan((4, 4, 20 * kernel.MAX_TILES_Z + 1), 4, 2)
    shape, r = SHAPES[1]
    types, occ = inputs(shape, r, "sparse")
    cfg = config(shape, r, 4, 2)
    sim = tuple(s // r for s in shape)
    inertia, f2 = torch.zeros(sim), torch.zeros(shape)
    monkeypatch.setattr(levelset, "kernel_choice", lambda cfg, device: True)
    monkeypatch.setattr(kernel, "on_cuda", lambda t: True)
    monkeypatch.setattr(levelset, "levelset_plain", None)
    with pytest.raises(ValueError, match="sweeps \\+ smooth <= 8"):
        update_surface_fields(types, occ, inertia, f2,
                              cfg.replace(levelset_sweeps=7))
    wide = torch.zeros((2, 2, 20 * kernel.MAX_TILES_Z + 1), dtype=torch.uint8)
    with pytest.raises(ValueError, match="boxes along z"):
        update_surface_fields(wide, wide, inertia, f2,
                              cfg.replace(grid_size=tuple(wide.shape),
                                          surface_render_resolution=1))


def test_the_wrapper_refuses_wrong_inputs(monkeypatch):
    shape, r = SHAPES[1]
    types, occ = inputs(shape, r, "sparse")
    cfg = config(shape, r, 4, 2)
    with pytest.raises(TypeError, match="occ"):
        kernel.levelset_cuda(types, occ.float(), cfg)
    with pytest.raises(TypeError, match="types"):
        kernel.levelset_cuda(types.int(), occ, cfg)
    with pytest.raises(ValueError, match="types"):
        kernel.levelset_cuda(types[1:], occ, cfg)
    with pytest.raises(ValueError, match="whole number"):
        kernel.levelset_cuda(types, occ[1:], cfg)
    with pytest.raises(TypeError, match="out f2"):
        kernel.levelset_cuda(types, occ, cfg,
                             out=(None, torch.empty(shape,
                                                    dtype=torch.float64)))
    with pytest.raises(ValueError, match="out"):
        kernel.levelset_cuda(types, occ, cfg, out=(None,))
    # a CUDA tensor's halo is checked before any launch
    monkeypatch.setattr(kernel, "on_cuda", lambda t: True)
    with pytest.raises(ValueError, match="sweeps \\+ smooth <= 8"):
        kernel.levelset_cuda(types, occ, cfg.replace(levelset_sweeps=7))


def test_cpu_tensors_take_the_plain_route():
    """The wrapper on CPU tensors is the plain passes, spans included,
    launching nothing; `levelset_fields` never asks for the kernel there,
    and writes f1 and f2 where given, else one tensor for both."""
    shape, r = SHAPES[1]
    types, occ = inputs(shape, r, "sparse")
    cfg = config(shape, r, 4, 2)
    want = levelset.levelset_plain(types, occ, cfg)
    before = kernel.levelset_cuda.launches
    profiling.tracing(True)
    try:
        f1, f2 = kernel.levelset_cuda(types, occ, cfg)
        rep = profiling.report()
    finally:
        profiling.tracing(False)
        profiling.reset()
    assert kernel.levelset_cuda.launches == before
    assert f1 is f2 and torch.equal(bits(f1), bits(want))
    assert "levelset.chamfer" in rep and "levelset.scan" not in rep
    given = (torch.full(shape, -7.0), torch.full(shape, -7.0))
    got = levelset.levelset_fields(types, occ, cfg, out=given)
    assert got[0] is given[0] and got[1] is given[1]
    assert torch.equal(bits(given[0]), bits(want))
    assert torch.equal(bits(given[1]), bits(want))
    one = levelset.levelset_fields(types, occ, cfg)
    assert one[0] is one[1] and torch.equal(bits(one[0]), bits(want))
    assert kernel.levelset_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("sweeps,smooth", [(4, 2), (1, 0), (6, 2), (0, 3)])
@pytest.mark.parametrize("occupancy", OCCUPANCIES)
@pytest.mark.parametrize("shape,r", SHAPES, ids=["13x20x37", "26x40x74"])
def test_cuda_kernel_equals_the_plain_passes(shape, r, occupancy, sweeps,
                                             smooth):
    """The kernel on the card: f1 and f2 bitwise the plain passes', the
    flagged live boxes the plain rule's, the band's cells the plain
    count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are compiled and run "
                    "only there")
    device = torch.device("cuda", 0)
    types, occ = (t.to(device) for t in inputs(shape, r, occupancy))
    cfg = config(shape, r, sweeps, smooth)
    want = levelset.levelset_plain(types, occ, cfg)
    given = (torch.full_like(want, -1e30), torch.full_like(want, -1e30))
    profiling.tracing(True)
    try:
        f1, f2 = kernel.levelset_cuda(types, occ, cfg, out=given)
        torch.cuda.synchronize()
        rep = profiling.report()
    finally:
        profiling.tracing(False)
        profiling.reset()
    assert f1 is given[0] and f2 is given[1]
    assert torch.equal(bits(f1), bits(want)) and torch.equal(bits(f2),
                                                             bits(want))
    band = levelset.band_cells(levelset.chamfer_distance(occ, sweeps), sweeps)
    assert rep["levelset.band_cells"]["count"] == int(band)
    p = kernel.plan(shape, sweeps, smooth, r)
    flagged = kernel.live_boxes_cuda(types, occ, cfg).tolist()
    assert flagged == kernel.live_boxes(p, occ)
    assert rep["levelset.live_boxes"]["count"] == len(flagged)
    assert rep["levelset.boxes"]["count"] == p.total
