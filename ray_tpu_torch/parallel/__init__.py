"""Port of ``ray_tpu.parallel``: meshes, sharding rules and the placement
of tensors by them, collectives, the pipeline schedules, ring and Ulysses
sequence parallelism, single-controller (``parallel.mesh``). Import from
the modules (``ray_tpu_torch.parallel.ring_attention`` is the module, not
a function re-exported over it)."""
