"""The x-slab multi-device step on `torch.distributed` (`tpu_fluid.parallel`):
`mesh` (process group and state layout), `halo` (neighbour planes and
collectives), `particles_domain` (particles on the shard that owns their
x-slab), `spmd_step` (the per-shard step) and `launch` (running one
process per shard)."""
