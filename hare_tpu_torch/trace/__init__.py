"""Multi-bounce tracing, impulse-response histograms, sampling (layer L4)."""

from .bounce import SOUND_SPEED, TraceResult, energy_histogram, reflect, trace_rays
from .sampler import uniform_sphere

__all__ = [
    "SOUND_SPEED",
    "TraceResult",
    "energy_histogram",
    "reflect",
    "trace_rays",
    "uniform_sphere",
]
