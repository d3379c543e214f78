"""The level-set surface field as one march over live boxes (CUDA source
`csrc/levelset.cu`).

Replaces no TPU kernel: the JAX package computes the level set in XLA
(`tpu_fluid/surface/levelset.py`), and its plain version here
(`surface/levelset.levelset_plain`) runs it as ~450 PyTorch passes over
the detailed grid.  The kernel computes the same field bitwise: the
chamfer sweeps (each weight class's minimum first, then its weight), the
clamp to `iso - min(phi, sweeps + 1)`, and the smoothing passes with the
cells under a SOLID sim cell kept, all in one march that keeps every
intermediate on chip and writes f1 and f2 once.

What bounds it: the bytes, 9 a detailed cell (the u8 occupancy read, f1
and f2 written) plus the sim cell types, if the work is one pass.  The
march runs the chamfer only on the live boxes (`Plan`): an inner tile of
the R = sweeps + smooth ring geometry times a segment of rows, live where
an occupied cell lies within Chebyshev distance R of it (`live_boxes` is
the plain rule).  Every other box holds the constant's smoothing, which
the march writes without reading the occupancy.  Two launches flag the
boxes and count the live ones on the device (`FLAG_LAUNCHES`), with no
host sync, and one marches them all in box order.  With tracing on
(`utils/profiling`) the wrapper's launches are the spans `levelset.scan`
and `levelset.march`, and it counts the band's cells on the device
(`levelset.band_cells`, through the march's counting form),
the live boxes (`levelset.live_boxes`, on the device) and all boxes
(`levelset.boxes`).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from tpu_fluid_torch.kernels import build, on_cuda, require, tiling
from tpu_fluid_torch.utils import profiling

# The largest sweeps + smooth a launch takes (template instances in
# csrc/levelset.cu): a 32 x 32 tile keeps an inner tile of 16 x 16 cells.
MAX_HALO = 8
# The most boxes along z (bits of the scan's mask words a y tile).
MAX_TILES_Z = 128
# Rows a box spans along x.
SEGMENT_ROWS = 32
# The scan and the flag kernel.
FLAG_LAUNCHES = 2

_LIVE_ARGTYPES = (build.POINTER,) * 3 + (build.INT,) * 7 + (build.POINTER,)
_MARCH_ARGTYPES = ((build.POINTER,) * 6 + (build.INT,) * 7
                   + (build.FLOAT,) * 4 + (build.INT, build.POINTER))


@dataclasses.dataclass(frozen=True)
class Plan:
    """The boxes of a level set on a detailed grid of `shape` with a ring
    of `ring` = sweeps + smooth cells: inner tiles of TILE - 2 ring cells
    along y and z, times segments of `seg` rows along x.  Box b is tile
    (b % tiles_z, b // tiles_z % tiles_y) of segment
    b // (tiles_z tiles_y)."""
    shape: tuple
    ring: int
    seg: int
    r: int = 1

    @property
    def inner(self) -> int:
        return tiling.TILE - 2 * self.ring

    @property
    def tiles(self) -> tuple:
        """(tiles along z, tiles along y)."""
        _, gy, gz = self.shape
        return -(-gz // self.inner), -(-gy // self.inner)

    @property
    def segments(self) -> int:
        return -(-self.shape[0] // self.seg)

    @property
    def total(self) -> int:
        tz, ty = self.tiles
        return tz * ty * self.segments

    @property
    def scratch_ints(self) -> int:
        """The flag kernels' scratch: each box's flag, the live count, the
        march's box counter, then the scan's masks (32 z tiles a word) of
        each detailed plane and each sim plane, by y tile."""
        tz, ty = self.tiles
        words = -(-tz // 32)
        return (self.total + 2
                + (self.shape[0] + self.shape[0] // self.r) * ty * words)

    def boxes(self):
        """Each box's cells ((x0, x1), (y0, y1), (z0, z1)), in box order."""
        nx, gy, gz = self.shape
        tz, ty = self.tiles
        n = self.inner
        for s in range(self.segments):
            x0 = s * self.seg
            for j in range(ty):
                for i in range(tz):
                    yield ((x0, min(x0 + self.seg, nx)),
                           (j * n, min(j * n + n, gy)),
                           (i * n, min(i * n + n, gz)))


@functools.lru_cache(maxsize=64)
def plan(shape, sweeps: int, smooth: int, r: int = 1) -> Plan:
    """The boxes of `sweeps` chamfer sweeps and `smooth` smoothing passes
    on a detailed grid of `shape` (r cells a sim cell along each axis);
    raises where sweeps + smooth is above MAX_HALO or the boxes along z
    above MAX_TILES_Z."""
    if sweeps < 0 or smooth < 0 or sweeps + smooth > MAX_HALO:
        raise ValueError(f"{sweeps} sweeps and {smooth} smoothing passes: "
                         f"the kernel takes sweeps + smooth <= {MAX_HALO}")
    shape = tuple(int(s) for s in shape)
    p = Plan(shape, sweeps + smooth, min(SEGMENT_ROWS, shape[0]), r)
    if p.tiles[0] > MAX_TILES_Z:
        raise ValueError(f"{p.tiles[0]} boxes along z: the kernel takes at "
                         f"most {MAX_TILES_Z}")
    return p


def dilate(occ: torch.Tensor, ring: int) -> torch.Tensor:
    """The cells within Chebyshev distance `ring` of an occupied cell, one
    axis at a time."""
    m = (occ != 0).to(torch.float32)[None, None]
    for k in range(3):
        size = [1, 1, 1]
        size[k] = 2 * ring + 1
        pad = [0, 0, 0]
        pad[k] = ring
        m = torch.nn.functional.max_pool3d(m, size, stride=1, padding=pad)
    return m[0, 0] > 0


def live_boxes(p: Plan, occ: torch.Tensor) -> list:
    """The plain rule: the boxes of `p` (indices into `p.boxes()`) with an
    occupied cell within `p.ring` cells of them."""
    near = dilate(occ, p.ring)
    return [i for i, box in enumerate(p.boxes())
            if bool(near[tuple(slice(lo, hi) for lo, hi in box)].any())]


def constants(cfg) -> tuple:
    """(iso, w2, w3, c7): the plain version's f32 constants, as Python
    floats: the iso level, the chamfer's edge and corner weights, and
    `div_const`'s reciprocal of 7."""
    from tpu_fluid_torch.ops.stencil import div_const
    from tpu_fluid_torch.surface import levelset as plain
    weights = {w for _, w in plain._CHAMFER26}
    one = torch.ones((), dtype=torch.float32)
    return (cfg.levelset_iso_value, min(weights - {1.0}),
            max(weights), float(div_const(one, 7.0)))


def device_launches() -> int:
    """Kernels the C entry points of `csrc/levelset.cu` have launched."""
    return build.launches("tf_levelset_launches")


def _check(types, occ, cfg, out):
    require(occ, "occ", torch.uint8)
    if occ.ndim != 3:
        raise ValueError(f"occ: shape {tuple(occ.shape)}, expected (X,Y,Z)")
    r = cfg.surface_render_resolution
    if any(s % r for s in occ.shape):
        raise ValueError(f"occ: shape {tuple(occ.shape)} is not a whole "
                         f"number of {r}-cell sim cells")
    require(types, "types", torch.uint8,
            tuple(s // r for s in occ.shape), occ.device)
    out = (None, None) if out is None else out
    if len(out) != 2:
        raise ValueError(f"out: {len(out)} tensors, expected (f1, f2)")
    for name, t in zip(("f1", "f2"), out):
        if t is not None:
            require(t, f"out {name}", torch.float32, occ.shape, occ.device)
    return out


def levelset_cuda(types: torch.Tensor, occ: torch.Tensor, cfg,
                  out=None) -> tuple:
    """The level set of `cfg` (sweeps, smoothing passes, iso level,
    `surface_render_resolution`) from the u8 (X/r, Y/r, Z/r) sim cell
    types and the u8 (X, Y, Z) detailed occupancy -> (f1, f2), each the
    f32 field, written into `out`'s two tensors where given (one tensor
    for both where no f2 is given).  The CUDA kernels for CUDA tensors,
    raising where sweeps + smooth is above MAX_HALO or the grid has more
    than MAX_TILES_Z boxes along z; the plain route of
    `surface/levelset.levelset_fields` for CPU tensors."""
    f1_to, f2_to = _check(types, occ, cfg, out)
    if not on_cuda(occ):
        from tpu_fluid_torch.surface.levelset import levelset_fields
        return levelset_fields(types, occ, cfg.replace(pallas_mode="off"),
                               out=(f1_to, f2_to))
    sweeps, smooth = cfg.levelset_sweeps_value, cfg.levelset_smooth
    r = cfg.surface_render_resolution
    p = plan(tuple(occ.shape), sweeps, smooth, r)
    iso, w2, w3, c7 = constants(cfg)
    with torch.cuda.device(occ.device):
        f1 = f1_to if f1_to is not None else torch.empty(
            occ.shape, dtype=torch.float32, device=occ.device)
        scratch = torch.empty(p.scratch_ints, dtype=torch.int32,
                              device=occ.device)
        stream = torch.cuda.current_stream(occ.device).cuda_stream
        with profiling.span("levelset.scan"):
            build.call("tf_levelset_live", _LIVE_ARGTYPES, occ.data_ptr(),
                       types.data_ptr(), scratch.data_ptr(), *occ.shape, r,
                       sweeps, smooth, p.seg, stream)
        traced = profiling.enabled()
        band = (torch.zeros((), dtype=torch.int64, device=occ.device)
                if traced else None)
        with profiling.span("levelset.march"):
            build.call("tf_levelset_march", _MARCH_ARGTYPES, occ.data_ptr(),
                       types.data_ptr(), scratch.data_ptr(), f1.data_ptr(),
                       f2_to.data_ptr() if f2_to is not None else None,
                       band.data_ptr() if traced else None, *occ.shape, r,
                       sweeps, smooth, p.seg, iso, w2, w3, c7,
                       build.sm_count(occ.device.index), stream)
        if traced:
            profiling.count_on_device("levelset.band_cells", band)
            profiling.count_on_device("levelset.live_boxes",
                                      scratch[p.total])
            profiling.count("levelset.boxes", p.total)
    levelset_cuda.launches += 1
    return f1, (f2_to if f2_to is not None else f1)


levelset_cuda.launches = 0


def live_boxes_cuda(types: torch.Tensor, occ: torch.Tensor,
                    cfg) -> torch.Tensor:
    """The live boxes as the flag kernels flag them for these CUDA inputs:
    an int64 tensor of box indices into `plan(...).boxes()`, in order."""
    _check(types, occ, cfg, None)
    sweeps, smooth = cfg.levelset_sweeps_value, cfg.levelset_smooth
    p = plan(tuple(occ.shape), sweeps, smooth,
             cfg.surface_render_resolution)
    with torch.cuda.device(occ.device):
        scratch = torch.empty(p.scratch_ints, dtype=torch.int32,
                              device=occ.device)
        stream = torch.cuda.current_stream(occ.device).cuda_stream
        build.call("tf_levelset_live", _LIVE_ARGTYPES, occ.data_ptr(),
                   types.data_ptr(), scratch.data_ptr(), *occ.shape,
                   cfg.surface_render_resolution, sweeps, smooth, p.seg,
                   stream)
        live = torch.nonzero(scratch[:p.total] & 1).flatten()
        if live.numel() != int(scratch[p.total]):
            raise RuntimeError("the live count differs from the flags")
        return live
