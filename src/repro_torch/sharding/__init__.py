"""Sharding on the single-controller mesh: the per-architecture
PartitionSpec rules (``rules``) and GPipe pipeline parallelism over the
'pod' axis (``pp``)."""
from . import rules

__all__ = ["rules"]
