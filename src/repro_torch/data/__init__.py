"""Vector datasets for the port's benchmarks and smoke runs."""

from .vectors import make_clustered, make_uniform, normalize_scale, paper_dataset_specs

__all__ = ["make_clustered", "make_uniform", "normalize_scale", "paper_dataset_specs"]
