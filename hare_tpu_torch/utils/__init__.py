"""Auxiliary subsystems: config, profiling, metrics, checkpoint, checks
(``hare_tpu/utils``): the surface an optimization sweep needs around the
tracing kernels."""

from .config import HareConfig
from .profiling import timed, trace_profile
from .metrics import MetricsLogger, trace_metrics
from .checkpoint import restore_state, save_state, latest_step
from .checks import determinism_check, enable_debug_checks

__all__ = [
    "HareConfig",
    "MetricsLogger",
    "determinism_check",
    "enable_debug_checks",
    "latest_step",
    "restore_state",
    "save_state",
    "timed",
    "trace_metrics",
    "trace_profile",
]
