"""Halo exchange and the collectives of the x-slab step
(`tpu_fluid.parallel.halo`), on `torch.distributed`.

`ppermute_neighbours` is JAX's pair of `ppermute`s between x-neighbours,
sent with one `batch_isend_irecv`: the shards at the domain ends receive
zeros, as ppermute leaves non-receivers, and one shard gets zeros without
any exchange.  `halo_planes` sends it the h boundary planes of a slab,
which makes the zeros the out-of-domain zero of every stencil stage;
domain-sharded particles send it their migration buffers.  The three
collectives of the particle stages are thin helpers here, so that
`parallel/spmd_step.py` reads like the JAX step: `all_gather_x`
(`jax.lax.all_gather(..., tiled=True)`), `psum_scatter_x`
(`jax.lax.psum_scatter(..., tiled=True)`) and `psum`.

Every helper sends device tensors on an nccl group and stages them
through the host on a gloo group (`Mesh.host_staged`).  Bool tensors
travel as uint8.

With tracing on (`utils/profiling`) each exchange between neighbours is
a span, `exchange.halo`, and adds the bytes this shard sends to the
counter `exchange.halo_bytes` (from the shapes: once a capture, then once
a replay).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpu_fluid_torch.core.types import CellType
from tpu_fluid_torch.parallel.mesh import Mesh
from tpu_fluid_torch.utils import profiling


def _to_wire(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if mesh.host_staged:
        t = t.cpu()
    return t.contiguous()


def _from_wire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.to(device=like.device, dtype=like.dtype)


def ppermute_neighbours(to_left: torch.Tensor, to_right: torch.Tensor,
                        mesh: Mesh):
    """(from_left, from_right): send `to_left` to the -x neighbour and
    `to_right` to the +x neighbour, and receive what they sent this way,
    in one `batch_isend_irecv`.  JAX's pair of ppermutes with pairs
    (j, j + 1) and (j + 1, j): the shards at the domain ends, and a single
    shard, receive zeros."""
    if mesh.size == 1:
        return torch.zeros_like(to_right), torch.zeros_like(to_left)
    with profiling.span("exchange.halo"):
        left = _to_wire(torch.zeros_like(to_right), mesh)
        right = _to_wire(torch.zeros_like(to_left), mesh)
        ops, sent = [], 0
        if mesh.rank > 0:
            ops += [dist.P2POp(dist.isend, _to_wire(to_left, mesh),
                               mesh.rank - 1, mesh.group),
                    dist.P2POp(dist.irecv, left, mesh.rank - 1, mesh.group)]
            sent += right.nbytes
        if mesh.rank < mesh.size - 1:
            ops += [dist.P2POp(dist.isend, _to_wire(to_right, mesh),
                               mesh.rank + 1, mesh.group),
                    dist.P2POp(dist.irecv, right, mesh.rank + 1, mesh.group)]
            sent += left.nbytes
        profiling.count("exchange.halo_bytes", sent)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return _from_wire(left, to_right), _from_wire(right, to_left)


def halo_planes(a: torch.Tensor, h: int, mesh: Mesh):
    """(from_left, from_right): the h planes next to this shard's slab on
    its -x and +x side.  The x axis is dim ndim-3, so (Lx, Y, Z) fields and
    (C, Lx, Y, Z) stacks both work.  Domain ends receive zeros."""
    ax = a.ndim - 3
    if not 0 < h <= a.shape[ax]:
        raise ValueError(f"halo of {h} planes from a slab of "
                         f"{a.shape[ax]} rows")
    return ppermute_neighbours(a.narrow(ax, 0, h),
                               a.narrow(ax, a.shape[ax] - h, h), mesh)


def halo_extend(a: torch.Tensor, h: int, mesh: Mesh) -> torch.Tensor:
    """Local (..., Lx, Y, Z) block -> (..., Lx + 2h, Y, Z) with the
    neighbours' planes (zeros past the domain ends)."""
    left, right = halo_planes(a, h, mesh)
    return torch.cat([left, a, right], dim=a.ndim - 3)


def halo_inner(a: torch.Tensor, h: int = 1) -> torch.Tensor:
    """Strip h halo planes from each side of the x axis (dim ndim-3)."""
    ax = a.ndim - 3
    return a.narrow(ax, h, a.shape[ax] - 2 * h)


def exchange_x_halo(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(Lx, Y, Z) -> (Lx + 2, Y, Z) with one neighbour plane a side."""
    return halo_extend(x, 1, mesh)


def all_gather_x(a: torch.Tensor, mesh: Mesh, axis: int) -> torch.Tensor:
    """Every shard's block, concatenated along `axis` in rank order."""
    if mesh.size == 1:
        return a
    wire = _to_wire(a, mesh)
    parts = [torch.empty_like(wire) for _ in range(mesh.size)]
    dist.all_gather(parts, wire, group=mesh.group)
    return _from_wire(torch.cat(parts, dim=axis), a)


def psum_scatter_x(a: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over shards of `a`, of which this shard keeps its chunk of
    dim 0."""
    if mesh.size == 1:
        return a
    if a.shape[0] % mesh.size:
        raise ValueError(f"dim 0 of {tuple(a.shape)} does not divide "
                         f"{mesh.size} shards")
    wire = _to_wire(a, mesh)
    out = torch.empty((a.shape[0] // mesh.size,) + tuple(a.shape[1:]),
                      dtype=wire.dtype, device=wire.device)
    dist.reduce_scatter_tensor(out, wire, group=mesh.group)
    return _from_wire(out, a)


def psum(a: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of `a` over shards, on every shard."""
    if mesh.size == 1:
        return a
    wire = _to_wire(a, mesh).clone()
    dist.all_reduce(wire, group=mesh.group)
    return _from_wire(wire, a)


def jacobi_solve_halo(mesh: Mesh, types: torch.Tensor, div: torch.Tensor,
                      cfg) -> torch.Tensor:
    """Sharded Jacobi solve with one plane exchanged a sweep, on local
    x-slabs of types and div; the result is this shard's slab of the
    pressure.  Same folded formulation, and the same bits, as
    `stages/pressure.jacobi_solve` on the full grid: the plain reference
    for the K-sweep passes of `kernels/jacobi.jacobi_sweeps_sharded_cuda`."""
    from tpu_fluid_torch.kernels.jacobi import (jacobi_fold_plain,
                                                jacobi_sweeps_sharded_plain)
    from tpu_fluid_torch.stages.pressure import fold_slab
    iters = cfg.jacobi_iters - (1 if cfg.reference_pressure_parity else 0)
    q0, code, c2e = fold_slab(
        jacobi_fold_plain, types, div.to(torch.float32),
        cfg.fluid_density * cfg.cell_width / cfg.dt, cfg.air_pressure, mesh)
    q = jacobi_sweeps_sharded_plain(q0, code, c2e, iters, mesh, k=1)
    return torch.where(types == CellType.WATER, q, cfg.air_pressure)
