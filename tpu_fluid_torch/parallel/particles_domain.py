"""Domain-sharded particles (`tpu_fluid.parallel.particles_domain`): each
shard owns the particles inside its x-slab
(`FluidConfig.particle_sharding="domain"`).

With particles split by index, stage 14 gathers the whole velocity field
on every shard and stage 15 sums the whole detailed occupancy over the
shards: two collectives that grow with the grid's volume.  With each
particle on the shard that owns its x-slab:

  - stage 14 samples a local slab with one edge-replicated plane a side
    (`edge_replicated_halo`) through K3+K4's local-slab form,
  - a fixed-capacity exchange with the two x-neighbours migrates the
    particles that crossed a slab border (`migrate`),
  - the detailed occupancy is scattered onto the local slab with no
    collective (`detailed_occupancy_local`),

so a step moves two migration buffers a direction and one velocity plane
a side: traffic that grows with the slab's surface.

Layout: every shard holds `slots` particle rows, sized from the initial
census of the fullest slab times `particle_slot_slack`
(`domain_shard_state`); the migration buffers hold `migrate_capacity` rows
a direction.  What does not fit is deactivated and counted into
`FluidState.dropped`, never lost silently.  A particle more than one slab
from home moves one hop a step and samples the clipped row until it
arrives.

Parity: each particle's move equals the single-device step's bitwise; the
particle set is preserved, its slot order is not the single-device one,
and `migrate` keeps JAX's slot order bitwise (the same stable category
sort and the same placement).  JAX's out-of-bounds modes are explicit
here: torch indexing raises (CPU) or asserts (CUDA) where JAX's fills or
drops, so every gather and scatter is in bounds by construction: the
migration writes each hole once, with an arrival or its own row, and the
occupancy scatter sends a dropped particle to a cell that is written 1
anyway.  So all three write into the tensors they are given (`out=`), as
the graphed step passes its donated set.  Coordinates convert to
cells as XLA converts them (`ops/indexing.float_to_index`), so a NaN or
infinite position goes where JAX sends it; `domain_shard_state` takes
its census with JAX's numpy code on the host.

With tracing on (`utils/profiling`), `migrate` adds the particles this
shard sends a step (the leavers that fit a buffer toward an existing
neighbour) to the device counter `exchange.migrate_sent`, with no host
sync; the x-slab step runs it inside the span `exchange.migrate`.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_fluid_torch.core.config import FluidConfig
from tpu_fluid_torch.core.state import FluidState
from tpu_fluid_torch.kernels import kernel_choice, require, store
from tpu_fluid_torch.kernels.particle_move import (particle_move_local_cuda,
                                                   particle_move_local_plain)
from tpu_fluid_torch.ops.indexing import float_to_index
from tpu_fluid_torch.parallel.halo import halo_planes, ppermute_neighbours
from tpu_fluid_torch.parallel.mesh import Mesh, shard_state
from tpu_fluid_torch.utils import profiling


def domain_slots(cfg: FluidConfig, n: int, census=None) -> int:
    """Particle slots a shard, a multiple of 128: the largest per-shard
    `census` (initial particle counts), or the mean particle_count / n
    without one, times the slack."""
    base = -(-cfg.particle_count // n)
    peak = base if census is None else max(1, int(np.max(census)))
    slots = max(peak, int(np.ceil(peak * cfg.particle_slot_slack)))
    return -(-slots // 128) * 128


def migrate_capacity(slots: int, cfg: FluidConfig) -> int:
    """Rows of each direction's migration buffer for a shard of `slots`
    particle slots."""
    return max(128, -(-int(slots * cfg.particle_migrate_frac) // 128) * 128)


def domain_shard_state(state: FluidState, rank: int, n: int,
                       cfg: FluidConfig) -> FluidState:
    """Shard `rank`'s part of a full state with domain-sharded particles:
    the x-slabs that `mesh.shard_state` cuts, and a segment of `slots` rows
    holding, in index order, the active particles whose cell x lies in its
    slab.  Every shard gets the same `slots` (from the census of the whole
    state), so `gather_state` puts the n segments together in rank order."""
    gx = cfg.grid_size[0]
    if gx % n:
        raise ValueError(f"grid x size {gx} must divide the mesh ({n})")
    lx = gx // n
    pos, act = state.positions, state.active
    # JAX's numpy census on the host, so that a non-finite x converts as
    # there whatever the device
    owner = torch.from_numpy(np.clip(np.floor(
        pos[:, 0].cpu().numpy()).astype(np.int64), 0, gx - 1) // lx
    ).to(pos.device)
    census = torch.bincount(owner[act], minlength=n).cpu().numpy()
    slots = domain_slots(cfg, n, census)
    if census.max(initial=0) > slots:
        # unreachable with census sizing; a drop at init must never be
        # silent (the reference activates exactly the cube)
        i = int(np.argmax(census))
        raise ValueError(f"domain_shard_state: shard {i} holds "
                         f"{census[i]} particles but only {slots} slots "
                         f"were sized")
    src = torch.nonzero(act & (owner == rank)).squeeze(1)
    new_pos = torch.zeros((slots, 3), dtype=pos.dtype, device=pos.device)
    new_act = torch.zeros((slots,), dtype=torch.bool, device=act.device)
    new_pos[:len(src)] = pos[src]
    new_act[:len(src)] = True
    return shard_state(state, rank, n)._replace(positions=new_pos,
                                                active=new_act)


def layout_state(state: FluidState, rank: int, n: int,
                 cfg: FluidConfig) -> FluidState:
    """Shard `rank`'s part of a full state as `cfg.particle_sharding` lays
    it out: `domain_shard_state`, or `mesh.shard_state` for index-sharded
    particles."""
    if cfg.particle_sharding == "domain":
        return domain_shard_state(state, rank, n, cfg)
    return shard_state(state, rank, n)


# ----------------------------------------------------------------- sampling
def edge_replicated_halo(a: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The slab with one neighbour plane a side, and at the domain ends its
    own edge plane instead of zeros: the velocity sampler's clamp-to-edge
    at the slab ends (`ops/packed_sampler._edge_shift` on a full grid)."""
    ax = a.ndim - 3
    left, right = halo_planes(a, 1, mesh)
    if mesh.rank == 0:
        left = a.narrow(ax, 0, 1)
    if mesh.rank == mesh.size - 1:
        right = a.narrow(ax, a.shape[ax] - 1, 1)
    return torch.cat([left, a, right], dim=ax)


def move_particles_local(vel_local: torch.Tensor, positions: torch.Tensor,
                         active: torch.Tensor, cfg: FluidConfig, x0: int,
                         mesh: Mesh, out=None) -> torch.Tensor:
    """Stage 14 on a local x-slab: K3+K4's local-slab form (the CUDA kernel
    where `kernel_choice` picks it, else its plain version) on the
    edge-replicated slab, with global positions and weights; the moved
    positions written into `out` where given."""
    vel_e = edge_replicated_halo(vel_local, mesh)
    move = (particle_move_local_cuda if kernel_choice(cfg, vel_e.device)
            else particle_move_local_plain)
    return move(vel_e, positions, active, cfg.dt, x0, cfg.grid_size,
                out=out)


# ---------------------------------------------------------------- migration
def migrate(positions: torch.Tensor, active: torch.Tensor, x0: int, lx: int,
            m: int, mesh: Mesh, out=None):
    """One-hop exchange after the move: the active particles whose cell x
    left [x0, x0 + lx) go, at most m a direction, to the x-neighbour and
    fill this shard's free slots in turn.  Returns (positions, active,
    n_dropped), where n_dropped is this shard's leavers less its arrivals
    placed: its sum over the shards is the particles lost to a full buffer,
    to full slots, or past a domain end.  One shard exchanges nothing and
    keeps every particle, as the single-device step does.

    `out` = (positions, active) are the tensors the result is written
    into; for a None entry, or no `out`, one shard returns that input
    itself and more shards a new tensor.  `out`'s positions may be
    `positions`: the senders are packed before any row is written."""
    out_pos, out_act = (None, None) if out is None else out
    if mesh.size == 1:
        return (*store((positions, active), (out_pos, out_act)),
                torch.zeros((), dtype=torch.int32, device=positions.device))
    cap = positions.shape[0]
    dev = positions.device
    cx = float_to_index(torch.floor(positions[:, 0]), torch.int32)
    go_l = active & (cx < x0)
    go_r = active & (cx >= x0 + lx)
    keep = active & ~go_l & ~go_r
    # one stable sort: [go_l ids | go_r ids | inactive ids | kept ids],
    # each segment in slot order
    cat = torch.where(go_l, 0, torch.where(go_r, 1, torch.where(keep, 3, 2)))
    order = torch.argsort(cat, stable=True)
    n_l = go_l.sum()
    n_r = go_r.sum()
    # m sentinels keep the go_r window inside the array for any n_l <= cap
    order_ext = torch.cat([order, torch.full((m,), cap - 1,
                                             dtype=order.dtype, device=dev)])
    lanes = torch.arange(m, device=dev)

    def pack(start, count):
        ids = order_ext.index_select(0, start + lanes)
        valid = (lanes < count).to(torch.int32)
        # rows past `count` hold other particles; the flags mask them
        rows = positions.index_select(0, torch.clamp(ids, 0, cap - 1))
        return rows, valid

    snd_l, val_l = pack(0, n_l)
    snd_r, val_r = pack(n_l, n_r)
    if profiling.enabled():
        sent = torch.zeros((), dtype=torch.int64, device=dev)
        if mesh.rank > 0:
            sent = sent + torch.clamp(n_l, max=m)
        if mesh.rank < mesh.size - 1:
            sent = sent + torch.clamp(n_r, max=m)
        profiling.count_on_device("exchange.migrate_sent", sent)
    in_l_pos, in_r_pos = ppermute_neighbours(snd_l, snd_r, mesh)
    in_l_val, in_r_val = ppermute_neighbours(val_l, val_r, mesh)
    in_pos = torch.cat([in_l_pos, in_r_pos])
    in_val = torch.cat([in_l_val, in_r_val])

    # the k-th valid arrival takes the k-th hole (the leading entries of
    # the sort: leavers, then inactive slots) while k < n_holes and
    # k < 2m: `placed` of them
    holes = order[:2 * m]
    n_holes = (~keep).sum()
    valid = in_val > 0
    rank = torch.cumsum(in_val, 0) - 1
    placed = (valid & (rank < n_holes) & (rank < 2 * m)).sum()
    # each hole written once: the k-th valid lane's row for k < placed,
    # else its own row and flag; no host sync, so capturable
    fill = torch.arange(len(holes), device=dev) < placed
    lane = torch.argsort(~valid, stable=True)[:len(holes)]
    pos = positions.clone() if out_pos is None else store(positions,
                                                          out_pos)
    pos.index_copy_(0, holes, torch.where(
        fill[:, None], in_pos.index_select(0, lane),
        pos.index_select(0, holes)))
    flags = keep if out_act is None else out_act.copy_(keep)
    flags.index_copy_(0, holes, fill | flags.index_select(0, holes))
    leavers = n_l + n_r
    return pos, flags, (leavers - placed).to(torch.int32)


# ----------------------------------------------------------------- scatters
def detailed_occupancy_local(positions: torch.Tensor, active: torch.Tensor,
                             cfg: FluidConfig, x0_det: int, lx_det: int,
                             out=None) -> torch.Tensor:
    """`stages/particles.detailed_occupancy` onto this shard's detailed
    x-slab [x0_det, x0_det + lx_det): every owned particle's detailed cell
    is local, and particles outside the slab are not scattered.  Written
    into `out` where given."""
    dy, dz = cfg.detailed_size[1], cfg.detailed_size[2]
    idx = float_to_index(torch.trunc(
        positions * float(cfg.surface_render_resolution)))
    x = idx[:, 0] - x0_det
    y, z = idx[:, 1], idx[:, 2]
    inb = ((x >= 0) & (x < lx_det) & (y >= 0) & (y < dy) & (z >= 0)
           & (z < dz) & active)
    shape = (lx_det, dy, dz)
    if out is None:
        out = torch.empty(shape, dtype=torch.uint8, device=positions.device)
    require(out, "out occupancy", torch.uint8, shape, positions.device)
    # no spare cell: a particle outside the slab writes the cell of one
    # inside it (the anchor), which is written 1 anyway; with none inside,
    # every particle writes a 0 at cell 0.  All writes then store one
    # value, so their order cannot matter, and no index or value comes
    # from the host, so a graph captures it.  (A uint8 max-reducing
    # scatter does the same with atomics, and is slower on the card.)
    flat = x * (dy * dz) + y * dz + z
    first = torch.argmax(inb.to(torch.uint8)).view(1)
    some = inb.index_select(0, first)
    anchor = torch.where(some, flat.index_select(0, first), 0)
    out.view(-1).zero_().index_put_(
        (torch.where(inb, flat, anchor),),
        some.to(torch.uint8).expand(inb.shape[0]))
    return out


def cell_histogram_local(positions: torch.Tensor, active: torch.Tensor,
                         grid_size, x0: int, lx: int) -> torch.Tensor:
    """The particle count of each cell of this shard's x-slab [x0, x0 + lx)
    (`ops/scatter.particle_cell_histogram` restricted to it), int32, with
    no collective: exact under the domain layout."""
    gy, gz = grid_size[1], grid_size[2]
    idx = float_to_index(torch.trunc(positions))
    x = idx[:, 0] - x0
    y, z = idx[:, 1], idx[:, 2]
    inb = ((x >= 0) & (x < lx) & (y >= 0) & (y < gy) & (z >= 0) & (z < gz)
           & active)
    flat = torch.where(inb, x * (gy * gz) + y * gz + z, 0)
    counts = torch.zeros(lx * gy * gz, dtype=torch.int32,
                         device=positions.device)
    counts.index_add_(0, flat, inb.to(torch.int32))
    return counts.reshape(lx, gy, gz)
