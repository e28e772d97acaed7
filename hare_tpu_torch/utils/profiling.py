"""Profiling hooks: device traces and honest wall-clock timing
(``hare_tpu/utils/profiling.py``).

- :func:`trace_profile` wraps ``torch.profiler.profile`` over the CPU and,
  where the card is there, CUDA activities, and writes a Chrome trace
  (view with Perfetto) into a directory.
- :func:`timed` measures the steady-state wall time of a callable: warm-up
  calls apart, then ``iters`` calls queued and one synchronisation of the
  device the result lives on, so per-call launch latency overlaps and the
  figure is the device's throughput where the host keeps ahead of it.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator, Optional, Tuple

import torch

__all__ = ["trace_profile", "timed"]


@contextlib.contextmanager
def trace_profile(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed region (CPU, and CUDA where available) and write
    its Chrome trace to ``log_dir/trace.json``.  Yields the profiler, whose
    ``key_averages()`` and ``events()`` the caller may read."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _device(result) -> Optional[torch.device]:
    """The device of the first tensor in ``result`` (nested tuples, lists
    and dicts), or None."""
    if isinstance(result, torch.Tensor):
        return result.device
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (tuple, list)):
        for x in result:
            dev = _device(x)
            if dev is not None:
                return dev
    return None


def _sync(result) -> None:
    """Wait until the work that made ``result`` has run: synchronise the
    CUDA device its first tensor lives on (nothing to wait for on the
    CPU)."""
    dev = _device(result)
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn: Callable, *args, iters: int = 10, warmup: int = 1) -> Tuple[float, object]:
    """``(seconds_per_call, last_result)`` of ``fn(*args)``: ``warmup``
    calls, one synchronisation, then ``iters`` calls queued and one
    synchronisation of the result's device."""
    result = None
    for _ in range(warmup):
        result = fn(*args)
    _sync(result)
    t0 = time.perf_counter()
    for _ in range(iters):
        result = fn(*args)
    _sync(result)
    return (time.perf_counter() - t0) / iters, result
