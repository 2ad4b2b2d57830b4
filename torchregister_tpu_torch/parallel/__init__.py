"""Cohorts: many independent pairs registered in one loop on one GPU
(counterpart of ``torchregister_tpu/parallel``). The JAX package's meshes
(``parallel/mesh.py``) shard a cohort over many TPU chips; on one card a
cohort is one batched loop, and a mesh raises."""
from .cohort import register_cohort

__all__ = ["register_cohort"]
