"""Cohorts and meshes (counterpart of ``torchregister_tpu/parallel``): many
independent pairs registered in one loop on one GPU, or split over a mesh's
``data`` axis; a volume split into slabs over a ``space`` axis
(``parallel/mesh.py``, ``parallel/halo.py``, ``parallel/data.py``)."""
from .mesh import (Mesh, NamedSharding, Sharded, batch_sharding, cohort_sharding, gather,
                   make_mesh, shard, volume_sharding)
from .cohort import register_cohort

__all__ = ["register_cohort", "make_mesh", "batch_sharding", "volume_sharding",
           "cohort_sharding", "shard", "gather", "Mesh", "NamedSharding", "Sharded"]
