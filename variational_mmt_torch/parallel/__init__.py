"""Data and vocab-parallel tensor parallelism over ``torch.distributed``
(mesh.py: the mesh, its process groups and collectives; tp.py: the
sharding rules and the vocab-parallel pieces). Mirrors
``variational_mmt_tpu/parallel/``."""

from variational_mmt_torch.parallel.mesh import Mesh, make_mesh, shard_batch  # noqa: F401
