"""Ranks and sharding over `torch.distributed` (port of
`tensoralloy_tpu/parallel/`): the mesh, the launcher and the collectives
that the data-parallel trainer, spatially sharded EFS, the replica-
sharded NEB and the member-sharded committee use."""
from .mesh import (Mesh, launch, make_mesh, replicate,  # noqa: F401
                   shard_batch)
