"""Launch geometry of the marching stencil kernels: K2's blocked route
(`csrc/jacobi.cu`), K5 (`csrc/surface_fused.cu`), K6a, K6b and K6c
(`csrc/grid_fused.cu`) and K1 (`csrc/advect.cu`).

The kernels apply a chain of 6-neighbour stencil levels (K2: Jacobi
sweeps; K5: stage 16+17, then the blur passes; K6a: the new cell types,
then the extrapolated velocity; K6b: the forced velocity, then the
divergence; K6c: the projection, one level) in each launch.  A block of
TILE x TILE threads owns the (y, z) positions of an extended tile, one or
two a thread (K5: `tile_z` = TILE along z; K2: 2 TILE): an inner tile of
(TILE - 2 halo) x (tile_z - 2 halo) cells with `halo` rings around it.
The block marches along x over its segment of output rows, one plane a
step, and keeps every level's newest plane in shared memory, so level s
is computed one plane behind level s - 1.  Each level loses one ring of
the tile (the TPU kernels' trapezoid turned sideways), and only the inner
tile of the last level is written.  Along x each segment starts `halo`
planes early and ends `halo` planes late: that is the x trapezoid.

The CUDA launchers take a `Pass` as it is planned here, and
tests/test_torch_tiling.py computes every block of a plan independently
from its own window with the plain PyTorch versions and stitches the inner
tiles, which must equal the plain versions on the whole grid bitwise.
K2's single-device solve marches only the boxes that `live_boxes` lists
(tests/test_torch_live_boxes.py holds that against the plain version the
same way).  Nothing here needs CUDA.
"""

from __future__ import annotations

import dataclasses
import functools

# Threads along each of y and z: one block of TILE * TILE = 1024 threads.
TILE = 32
# Blur passes one K5 launch holds (template instances in
# csrc/surface_fused.cu); more run as further launches of blur passes only.
MAX_LEVELS = 8
# Streaming multiprocessors of an H100 SXM; the wrappers pass the card's.
DEFAULT_SMS = 132


@dataclasses.dataclass(frozen=True)
class Pass:
    """One launch of a marching kernel.

    It applies `levels` stencil levels to an input of shape `shape`
    (rows, Y, Z) that lose `halo` rings in all; writes the output rows
    [xs, xe) (input row numbers) to an output whose row 0 is input row
    `out_x0`; and cuts those rows into segments of `seg` rows, one block
    per segment and tile."""
    levels: int
    halo: int
    shape: tuple
    xs: int
    xe: int
    seg: int
    out_x0: int = 0
    tile_z: int = TILE
    tile_y: int = TILE

    @property
    def inner_y(self) -> int:
        return self.tile_y - 2 * self.halo

    @property
    def inner_z(self) -> int:
        return self.tile_z - 2 * self.halo

    @property
    def tiles(self) -> tuple:
        """(tiles along z, tiles along y)."""
        _, gy, gz = self.shape
        return -(-gz // self.inner_z), -(-gy // self.inner_y)

    @property
    def segments(self) -> int:
        return -(-(self.xe - self.xs) // self.seg)

    @property
    def n_blocks(self) -> int:
        tz, ty = self.tiles
        return tz * ty * self.segments

    def blocks(self):
        """Each block's output box ((x0, x1), (y0, y1), (z0, z1)), as the
        kernel derives it from its block index."""
        _, gy, gz = self.shape
        tz, ty = self.tiles
        ny, nz = self.inner_y, self.inner_z
        for s in range(self.segments):
            x0 = self.xs + s * self.seg
            for j in range(ty):
                for i in range(tz):
                    yield ((x0, min(x0 + self.seg, self.xe)),
                           (j * ny, min(j * ny + ny, gy)),
                           (i * nz, min(i * nz + nz, gz)))


@dataclasses.dataclass(frozen=True)
class Plan:
    """`route` is "copy" (no level to apply), "whole" (K2's one-block
    route, `parts` threads a column) or "blocked" (the `passes`, launched
    in order, each reading the output of the one before).  `listed`: the
    passes share one box geometry and march only its live boxes
    (`live_boxes`), after `LIVE_LIST_LAUNCHES` launches that list them."""
    route: str
    passes: tuple = ()
    parts: int = 0
    listed: bool = False


def _segment_cost(rows: int, halo: int, tiles: int, sms: int,
                  seg: int) -> int:
    """Planes a launch of one block a tile and segment of seg rows takes:
    one 1024-thread block fills an SM, so b blocks take ceil(b / sms)
    waves, and a block marches seg + 2 * halo planes."""
    return -(-(tiles * -(-rows // seg)) // sms) * (seg + 2 * halo)


@functools.lru_cache(maxsize=None)
def segment_rows(rows: int, halo: int, tiles: int,
                 sms: int = DEFAULT_SMS) -> int:
    """Output rows per block along x: the s that minimises
    `_segment_cost` (the fewest segments among equals)."""
    best = None
    for nseg in range(1, rows + 1):
        seg = -(-rows // nseg)
        cost = _segment_cost(rows, halo, tiles, sms, seg)
        if best is None or cost < best[0]:
            best = (cost, seg)
    return best[1]


def _pass(levels, halo, shape, xs, xe, sms, out_x0=0,
          tile_z=TILE) -> Pass:
    if TILE - 2 * halo < 1:
        raise ValueError(f"a halo of {halo} leaves no inner tile")
    probe = Pass(levels, halo, tuple(shape), xs, xe, 1, tile_z=tile_z)
    tz, ty = probe.tiles
    seg = segment_rows(xe - xs, halo, tz * ty, sms)
    return dataclasses.replace(probe, seg=seg, out_x0=out_x0)


# ------------------------------------------------------------------ K2
# Sweeps a blocked pass holds (template instances in csrc/jacobi.cu).  Each
# thread computes two z cells of a 32 x PAIR_TILE_Z tile: at 4 sweeps a
# sweep computes 2048 positions for 24 x 56 = 1344 inner cells, and the
# two cells fill the 64 registers a thread that 1024-thread blocks leave.
BLOCKED_K = 4
PAIR_TILE_Z = 2 * TILE
# The one-block route: up to WHOLE_THREADS threads, each keeping a chunk
# of at most WHOLE_MAX_CHUNK rows of one (y, z) column in registers, and
# two copies of q, each plane with a zero ring, in shared memory (at most
# SHARED_BYTES, the 227 KB a Hopper block may opt into).
WHOLE_THREADS = 1024
WHOLE_MAX_CHUNK = 12
SHARED_BYTES = 232448


# The single-device solve's listed march (csrc/jacobi.cu's note has the
# argument).  A box, an inner tile of the BLOCKED_K-ring geometry times a
# segment of `live_segment_rows` rows, is live if one of its cells has
# code > 0: the others hold c2e after any sweep.  Every pass, the remainder
# pass too, marches the live boxes.  The guard makes every box live where
# a c2e, or a q0 where the code is > 0, exceeds LIVE_LIMIT in magnitude or
# is not finite, a cell with code 0 has c2e = -0.0, or a solve has
# LIVE_MAX_SWEEPS sweeps or more: below those, the iterates of K2f's
# inputs (whose q0 is c2e where the code is 0) keep every sum finite.
LIVE_LIMIT = 2.0 ** 100
LIVE_MAX_SWEEPS = 2 ** 20
# The list kernels: one scans each box (and fills), one compacts the list.
LIVE_LIST_LAUNCHES = 2


def _k2_pass(levels, shape, xs, xe, sms, out_x0=0) -> Pass:
    return _pass(levels, levels, shape, xs, xe, sms, out_x0, PAIR_TILE_Z)


@functools.lru_cache(maxsize=None)
def live_segment_rows(rows: int, halo: int, tiles: int,
                      sms: int = DEFAULT_SMS) -> int:
    """Output rows per box of the listed march.  It launches one block an
    SM, each taking the listed boxes in turn, so with every box live a
    pass takes the dense launch's `_segment_cost` in rounds.  The fewest
    rows whose cost is no more than the dense launch's (`segment_rows`,
    which takes the most among equals): a solve with every box live costs
    no more than the dense march, and one with few live boxes marches
    short boxes."""
    dense = segment_rows(rows, halo, tiles, sms)
    limit = _segment_cost(rows, halo, tiles, sms, dense)
    return min(seg for seg in range(1, dense + 1)
               if _segment_cost(rows, halo, tiles, sms, seg) <= limit)


def live_boxes(p: Pass, q0, code, c2e, n_iters: int) -> list:
    """The boxes of a listed pass `p` (indices into `p.blocks()`) that the
    list kernels list for these (X,Y,Z) inputs, by the rule above: those
    that hold a cell with code > 0, or every box where the guard fails.
    Takes torch tensors (or anything with their methods)."""
    boxes = list(p.blocks())
    dry = code == 0
    exact = (n_iters < LIVE_MAX_SWEEPS
             and bool((dry | (q0.abs() <= LIVE_LIMIT)).all())
             and bool((c2e.abs() <= LIVE_LIMIT).all())
             and not bool((dry & (c2e == 0) & c2e.signbit()).any()))
    if not exact:
        return list(range(len(boxes)))
    return [i for i, box in enumerate(boxes)
            if bool(code[tuple(slice(lo, hi) for lo, hi in box)].any())]


def whole_grid_parts(shape) -> int | None:
    """Threads a column on the one-block route (as many as fit, each with
    an equal chunk of rows, none empty), or None where the grid does not
    fit it."""
    gx, gy, gz = shape
    plane = gy * gz
    if (plane > WHOLE_THREADS
            or 2 * 4 * gx * (gy + 2) * (gz + 2) > SHARED_BYTES):
        return None
    chunk = -(-gx // min(WHOLE_THREADS // plane, gx))
    return -(-gx // chunk) if chunk <= WHOLE_MAX_CHUNK else None


def jacobi_plan(shape, n_iters: int, *, halo: int = 0,
                sms: int = DEFAULT_SMS) -> Plan:
    """K2's launches for `n_iters` sweeps.

    Single device (halo = 0): none for 0 sweeps; the one-block route where
    the grid fits it; else passes of `BLOCKED_K` sweeps over all rows and a
    remainder pass, listed: all on the boxes of the BLOCKED_K-ring
    geometry, `live_segment_rows` rows long.  Sharded pass (halo = h > 0,
    `jacobi_pass_cuda`): n_iters = kk <= h sweeps on a slab of h + lx + h
    rows whose interior is written; passes of at most BLOCKED_K sweeps over
    shrinking row ranges.  Plans are cached: the solve asks for the same
    one every step."""
    return _jacobi_plan(tuple(shape), n_iters, halo, sms)


@functools.lru_cache(maxsize=256)
def _jacobi_plan(shape, n_iters, halo, sms) -> Plan:
    nx = shape[0]
    if halo == 0:
        if n_iters <= 0:
            return Plan("copy")
        parts = whole_grid_parts(shape)
        if parts:
            return Plan("whole", parts=parts)
        k = BLOCKED_K
        counts = [k] * (n_iters // k) + ([n_iters % k] if n_iters % k else [])
        probe = _k2_pass(k, shape, 0, nx, sms)
        tz, ty = probe.tiles
        seg = live_segment_rows(nx, k, tz * ty, sms)
        return Plan("blocked", tuple(
            dataclasses.replace(probe, levels=c, seg=seg) for c in counts),
            listed=True)
    if not 1 <= n_iters <= halo or nx <= 2 * halo:
        raise ValueError(f"{n_iters} sweeps on a slab of {nx} rows with "
                         f"{halo}-plane halos")
    passes, done = [], 0
    while done < n_iters:
        c = min(BLOCKED_K, n_iters - done)
        done += c
        lo = halo - n_iters + done
        passes.append(_k2_pass(c, shape, lo, nx - lo, sms,
                               out_x0=halo if done == n_iters else 0))
    return Plan("blocked", tuple(passes))


# ------------------------------------------------------------------ K5
def surface_plan(shape, steps: int, *, halo: int = 0,
                 sms: int = DEFAULT_SMS) -> tuple:
    """K5's launches.  The first runs stage 16+17 and up to MAX_LEVELS blur
    passes (levels + 1 rings lost); each further one runs up to MAX_LEVELS
    more blur passes on the (f1, f2) pair the launch before it wrote, with
    one spare ring.  Every launch writes the rows its successors need, to
    outputs whose row 0 is its input row `xs`: in the end the rows
    [halo, rows - halo) (halo = 0 on a single device, steps + 1 in the halo
    form).  A launch after the first reads the previous one's outputs, so
    its `shape` and rows count from that output's row 0."""
    if steps < 0:
        raise ValueError(f"float_density_diffuse_steps = {steps} < 0")
    return _surface_plan(tuple(shape), steps, halo, sms)


@functools.lru_cache(maxsize=256)
def _surface_plan(shape, steps, halo, sms) -> tuple:
    nx = shape[0]
    if nx <= 2 * halo or 0 < halo <= steps:
        raise ValueError(f"{steps} blur passes on a slab of {nx} rows with "
                         f"{halo}-plane halos")
    passes, done, lo_in = [], 0, 0
    while not passes or done < steps:
        c = min(MAX_LEVELS, steps - done)
        done += c
        # rows still to lose after this launch, on each side
        lo = max(halo - (steps - done), 0)
        rows = (nx - 2 * lo_in,) + shape[1:]
        passes.append(_pass(c, c + 1, rows, lo - lo_in, nx - lo - lo_in,
                            sms, out_x0=lo - lo_in))
        lo_in = lo
    return tuple(passes)


# ------------------------------------------------------------------ K6
# Rings each K6 march loses: K6a's output reads new types at i - e_c, whose
# AIR test reads occupancy at i - 2 e_c; K6b's divergence reads the forced
# velocity at i + e_c, which reads the types at i.
CLASSIFY_HALO = 2
FORCES_HALO = 1


def grid_fused_pass(shape, halo: int, *, slab_halo: int = 0,
                    sms: int = DEFAULT_SMS) -> Pass:
    """The one launch of K6a (halo = CLASSIFY_HALO) or K6b (FORCES_HALO)
    on inputs of `shape` (rows, Y, Z): 2 levels, output rows [slab_halo,
    rows - slab_halo) to an output whose row 0 is input row slab_halo
    (slab_halo = 0 on a single device; the halo forms' neighbour planes
    a side otherwise)."""
    return _grid_fused_pass(tuple(shape), halo, slab_halo, sms)


@functools.lru_cache(maxsize=256)
def _grid_fused_pass(shape, halo, slab_halo, sms) -> Pass:
    if shape[0] <= 2 * slab_halo:
        raise ValueError(f"a slab of {shape[0]} rows with {slab_halo}-plane "
                         f"halos")
    return _pass(2, halo, shape, slab_halo, shape[0] - slab_halo, sms,
                 out_x0=slab_halo)


# K6c's tile: PROJECT_ROWS x PROJECT_COLS (y, z) cells, one thread a cell
# (csrc/grid_fused.cu kProjectRows, kProjectCols).
PROJECT_COLS = 64
PROJECT_ROWS = TILE * TILE // PROJECT_COLS


def project_pass(shape, *, sms: int = DEFAULT_SMS) -> Pass:
    """The one launch of K6c on a field of `shape` (rows, Y, Z), on a
    single device or a slab: 1 level with no halo, all rows written.
    Stage 13 reads only lower neighbours, so a block reads its box and, of
    the types and pressure only, the plane, row and column just below it
    (its low ring, from the left halo plane before a slab's first row),
    and its tile is its output."""
    return _project_pass(tuple(shape), sms)


@functools.lru_cache(maxsize=256)
def _project_pass(shape, sms) -> Pass:
    probe = Pass(1, 0, shape, 0, shape[0], 1, tile_y=PROJECT_ROWS,
                 tile_z=PROJECT_COLS)
    tz, ty = probe.tiles
    # a block marches its rows and about two planes more: the row before
    # them and the prefetch's lead (costed as a 1-plane halo a side)
    seg = segment_rows(shape[0], 1, tz * ty, sms)
    return dataclasses.replace(probe, seg=seg)
