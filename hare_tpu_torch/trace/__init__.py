"""Multi-bounce tracing, impulse-response histograms, sampling (layer L4)."""

from .bounce import (
    SOUND_SPEED,
    TraceResult,
    bounce_step,
    cosine_lobe,
    energy_histogram,
    reflect,
    trace_rays,
)
from .sampler import (
    polygon_points,
    scene_surface_points,
    triangle_points,
    uniform_sphere,
)

__all__ = [
    "SOUND_SPEED",
    "TraceResult",
    "bounce_step",
    "cosine_lobe",
    "energy_histogram",
    "polygon_points",
    "reflect",
    "scene_surface_points",
    "trace_rays",
    "triangle_points",
    "uniform_sphere",
]
