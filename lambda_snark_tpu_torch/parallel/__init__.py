"""parallel subpackage: meshes, the sharded NTT and prove step, the
sharded service, and joining a ``torch.distributed`` world (the
counterpart of the JAX package's ``parallel/__init__.py``).

Public surface:
- ``mesh.make_mesh`` / ``mesh.ring_mesh``: meshes (dp, sp axes) over the world
- ``ntt_sharded.ShardedNtt``: four-step NTT over a mesh axis (2 all_to_alls)
- ``pipeline_sharded.ShardedProver``: the batched prove step on a (dp, sp)
  mesh with an all_reduce for validity
- ``service.ShardedProofService``: a witness stream over the mesh, with resume
- ``multihost``: ``init_process_group``, local worlds (``spawn_local``),
  scaling sweeps
"""

from .mesh import make_mesh, ring_mesh  # noqa: F401
