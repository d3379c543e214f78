"""Packed-neighbourhood staggered velocity sampler
(`tpu_fluid.ops.packed_sampler`).

For every cell j one 64-lane row holds every velocity value a particle inside
j can touch: for component c, offsets {0,1} along axis c and {-1,0,1} along
the two other axes (2*3*3 = 18 values per component, 54 per cell, padded to
64).  The JAX package built the table because the TPU has no fast element
gather; on the GPU the particle kernel (`kernels/particle_move.py`) reads
the same values straight from the velocity field, and the table stays as
its plain version's first half and as the JAX formulation the tests compare
against.
"""

from __future__ import annotations

import torch

from tpu_fluid_torch.ops.indexing import float_to_index

LANES = 64
_OTHER = {0: (1, 2), 1: (0, 2), 2: (0, 1)}


def _lane(c: int, dc: int, d1: int, d2: int) -> int:
    """Lane index for component c, offset dc in {0,1} along axis c, offsets
    d1,d2 in {-1,0,1} along the two other axes (ascending axis order)."""
    return c * 18 + dc * 9 + (d1 + 1) * 3 + (d2 + 1)


def _edge_shift(a: torch.Tensor, offset) -> torch.Tensor:
    """out[i] = a[clip(i + offset)] over the first three axes — the
    edge-replicated (clamp-to-edge) shift."""
    for ax, off in enumerate(offset):
        if off:
            n = a.shape[ax]
            idx = torch.clamp(torch.arange(n, device=a.device) + off,
                              0, n - 1)
            a = a.index_select(ax, idx)
    return a


def build_packed_table(vel: torch.Tensor) -> torch.Tensor:
    """vel (3, X, Y, Z) -> packed table (X*Y*Z, 64)."""
    gx, gy, gz = vel.shape[1:]
    zero = torch.zeros_like(vel[0])
    lanes = [zero] * LANES
    for c in range(3):
        a1, a2 = _OTHER[c]
        for dc in (0, 1):
            for d1 in (-1, 0, 1):
                for d2 in (-1, 0, 1):
                    off = [0, 0, 0]
                    off[c] = dc
                    off[a1] = d1
                    off[a2] = d2
                    lanes[_lane(c, dc, d1, d2)] = _edge_shift(
                        vel[c], tuple(off))
    return torch.stack(lanes, dim=-1).reshape(gx * gy * gz, LANES)


def cell_index(pos: torch.Tensor, grid_size) -> torch.Tensor:
    """(P, 3) int64 cell of each position: floor, converted as XLA
    converts (a NaN to 0, an infinity to the type's bound), then clipped to
    the grid."""
    j = float_to_index(torch.floor(pos))
    return torch.stack([torch.clamp(j[:, d], 0, grid_size[d] - 1)
                        for d in range(3)], dim=-1)


def packed_row_indices(pos: torch.Tensor, grid_size) -> torch.Tensor:
    """Flat table-row index of each particle's cell (clipped to the grid)."""
    _, gy, gz = grid_size
    j = cell_index(pos, grid_size)
    return j[:, 0] * (gy * gz) + j[:, 1] * gz + j[:, 2]


def sample_velocity_packed(table: torch.Tensor, grid_size,
                           pos: torch.Tensor) -> torch.Tensor:
    """Staggered velocity (P, 3) at positions (P, 3) from a packed table;
    equivalent to ops/sampling.velocity_at."""
    rows = table.index_select(0, packed_row_indices(pos, grid_size))
    return apply_packed_rows(rows, grid_size, pos)


def apply_packed_rows(rows: torch.Tensor, grid_size,
                      pos: torch.Tensor) -> torch.Tensor:
    """The weight/reduction half of the packed sampler, in the JAX
    package's XLA formulation: (P, 64) rows + (P, 3) positions -> (P, 3).
    The 18 lanes of a component are summed with `torch.sum`, whose order is
    its own; the particle kernel's plain version accumulates lane by lane
    instead."""
    top = [float(g) - 1.0 for g in grid_size]
    jf = cell_index(pos, grid_size).to(pos.dtype)
    deltas = torch.arange(-1.0, 2.0, dtype=pos.dtype, device=pos.device)
    out = []
    for c in range(3):
        a1, a2 = _OTHER[c]
        t = torch.stack([torch.clamp(pos[:, d] - 0.5 + (0.5 if d == c
                                                        else 0.0),
                                     0.0, top[d]) for d in range(3)],
                        dim=-1)
        i0 = torch.floor(t)
        f = t - i0
        o = i0 - jf
        wc = torch.stack([1.0 - f[:, c], f[:, c]], dim=-1)       # (P, 2)

        def axis_w(d):
            od = o[:, d]
            fd = f[:, d]
            # a select, as XLA makes of JAX's mask product: a NaN offset
            # weighs 0
            lo = torch.where(od[:, None] == deltas[None, :],
                             1.0 - fd[:, None], 0.0)
            hi = torch.where((od + 1.0)[:, None] == deltas[None, :],
                             fd[:, None], 0.0)
            return lo + hi                                       # (P, 3)

        w = (wc[:, :, None, None] * axis_w(a1)[:, None, :, None]
             * axis_w(a2)[:, None, None, :]).reshape(-1, 18)
        block = rows[:, c * 18:(c + 1) * 18]
        out.append(torch.sum(block * w, dim=-1))
    return torch.stack(out, dim=-1)
