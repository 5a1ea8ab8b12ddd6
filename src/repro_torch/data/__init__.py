"""Vector datasets for the port's benchmarks and smoke runs."""

from .vectors import make_clustered, normalize_scale

__all__ = ["make_clustered", "normalize_scale"]
