"""Model configurations and the ``--arch`` registry: copies of the
reference's ``configs/`` (all ten architectures and the TSQR workloads)."""
from .base import SHAPES, ModelConfig, ShapeSpec, get_config, list_archs, register, shapes_for

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "register", "get_config", "list_archs",
           "shapes_for"]
