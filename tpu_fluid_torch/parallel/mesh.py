"""The x-slab layout on `torch.distributed`, one process per shard
(`tpu_fluid.parallel.mesh`).

JAX puts every shard of one program on a 1-D device mesh; here each shard
is a process of a process group.  `make_mesh` joins the group and names the
shard's device, `shard_state` cuts a full state into this shard's part as
`state_pspecs` lays it out for index-sharded particles (3-D fields in
x-slabs, particles by index, `step` and `dropped` replicated), and
`gather_state` puts the parts back together on every rank, as
`jax.device_get` does for a sharded state.

With domain-sharded particles (`particles_domain.domain_shard_state`) the
3-D fields are cut the same way, but each shard's `positions` and `active`
are a segment of `slots` rows holding the particles of its x-slab, with the
same `slots` on every shard: `gather_state` then returns n * slots rows,
the segments in rank order, as JAX's domain layout has them.

Transport: an `nccl` group sends device tensors.  A `gloo` group sends host
tensors, so on a CUDA device every halo plane and collective buffer is
staged through the host; this is how several ranks share one card, the
counterpart of the JAX tests' virtual CPU mesh (`tests/conftest.py`).
"""

from __future__ import annotations

import dataclasses
from datetime import timedelta

import torch
import torch.distributed as dist

from tpu_fluid_torch.core.state import FluidState

# Fields cut into x-slabs; the detailed ones have surface_render_resolution
# times as many rows.  Velocity splits its dim 1, the others dim 0.
SLAB_FIELDS = ("velocity", "cell_types", "inertia", "float_dens_1",
               "float_dens_2", "detailed_occ")
PARTICLE_FIELDS = ("positions", "active")

DEFAULT_TIMEOUT = timedelta(seconds=120)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the x-slab layout: shard `rank` of `size`,
    its tensors on `device`.  `group` is None for a single shard."""
    rank: int
    size: int
    device: torch.device
    group: object = None

    @property
    def backend(self) -> str | None:
        return None if self.group is None else dist.get_backend(self.group)

    @property
    def host_staged(self) -> bool:
        """True where the transport copies device tensors through the
        host: a gloo group on a CUDA device."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def transport(self) -> str:
        if self.group is None:
            return "none (one shard)"
        if self.host_staged:
            return "gloo, host-staged device tensors"
        return f"{self.backend}, {self.device.type} tensors"


def make_mesh(n_shards: int, rank: int = 0, init_method: str | None = None,
              device="cuda", backend: str = "gloo",
              timeout: timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """Join a process group of `n_shards` ranks as `rank` and return this
    rank's Mesh.  One shard needs no group.  `device` is the card unless
    the caller passes "cpu": "cuda" means the current CUDA device for gloo
    (several ranks may share it; their transport is staged through the
    host) and `cuda:<rank>` for nccl, which needs one card per rank and
    raises, as JAX's `make_mesh` does, when there are fewer.  An nccl
    rank's card becomes its current CUDA device before the group is made,
    so that its communicators live on that card."""
    if not 0 <= rank < n_shards:
        raise ValueError(f"rank {rank} outside a mesh of {n_shards}")
    if backend == "nccl":
        visible = torch.cuda.device_count()
        if visible < n_shards:
            raise RuntimeError(
                f"requested a {n_shards}-rank nccl mesh but only {visible} "
                f"CUDA device(s) are visible; several ranks on one card "
                f"need backend='gloo'")
    elif backend != "gloo":
        raise ValueError(f"unknown backend {backend!r}")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank if backend == "nccl"
                              else torch.cuda.current_device())
    if backend == "nccl" and device.type == "cuda":
        torch.cuda.set_device(device)
    if n_shards == 1:
        return Mesh(0, 1, device)
    if init_method is None:
        raise ValueError("a mesh of several ranks needs an init_method")
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method, rank=rank,
            world_size=n_shards, timeout=timeout,
            device_id=device if backend == "nccl" else None)
    mesh = Mesh(rank, n_shards, device, dist.group.WORLD)
    if rank == 0:
        print(f"mesh of {n_shards} shards on {device}: transport "
              f"{mesh.transport()}", flush=True)
    return mesh


def shard_state(state: FluidState, rank: int, n_shards: int) -> FluidState:
    """Shard `rank`'s part of a full state with index-sharded particles:
    the x-slabs of the 3-D fields, the particle index chunk, `step` and
    `dropped` as they are."""
    parts = {}
    for name in FluidState._fields:
        a = getattr(state, name)
        if name in SLAB_FIELDS:
            dim = 1 if name == "velocity" else 0
            parts[name] = a.chunk(n_shards, dim=dim)[rank].contiguous()
        elif name in PARTICLE_FIELDS:
            parts[name] = a.chunk(n_shards, dim=0)[rank].contiguous()
        else:
            parts[name] = a
    return FluidState(**parts)


def shard_scene(scene, rank: int, n_shards: int):
    """Shard `rank`'s part of a SceneFields: the x-slabs of its solid mask
    and of its force field (dim 1), absent fields left absent."""
    if scene is None:
        return None
    solid, force = scene
    return type(scene)(
        solid=None if solid is None
        else solid.chunk(n_shards, dim=0)[rank].contiguous(),
        force=None if force is None
        else force.chunk(n_shards, dim=1)[rank].contiguous())


def gather_state(local: FluidState, mesh: Mesh) -> FluidState:
    """The full state from every shard's part, on every rank."""
    from tpu_fluid_torch.parallel.halo import all_gather_x
    if mesh.size == 1:
        return local
    parts = {}
    for name in FluidState._fields:
        a = getattr(local, name)
        if name in SLAB_FIELDS:
            parts[name] = all_gather_x(a, mesh, axis=1 if name == "velocity"
                                       else 0)
        elif name in PARTICLE_FIELDS:
            parts[name] = all_gather_x(a, mesh, axis=0)
        else:
            parts[name] = a
    return FluidState(**parts)
