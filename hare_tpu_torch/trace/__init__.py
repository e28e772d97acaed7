"""Multi-bounce tracing, impulse-response histograms, sampling (layer L4)."""

from .bounce import (
    SOUND_SPEED,
    BounceState,
    TraceResult,
    bounce_bwd_kernel,
    bounce_bwd_plain,
    bounce_kernel,
    bounce_step,
    bounce_step_bwd,
    cosine_lobe,
    energy_histogram,
    fused_bounce_step,
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
    "BounceState",
    "TraceResult",
    "bounce_bwd_kernel",
    "bounce_bwd_plain",
    "bounce_kernel",
    "bounce_step",
    "bounce_step_bwd",
    "cosine_lobe",
    "energy_histogram",
    "fused_bounce_step",
    "polygon_points",
    "reflect",
    "scene_surface_points",
    "trace_rays",
    "triangle_points",
    "uniform_sphere",
]
