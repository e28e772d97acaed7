"""The float64 NumPy oracle (reference semantics), copied from ``hare_tpu``."""

from .oracle import (
    mt_intersect,
    oracle_shoot,
    oracle_trace,
    slab_intersect,
)

__all__ = ["mt_intersect", "oracle_shoot", "oracle_trace", "slab_intersect"]
