"""The dynamic-gather probe of ``benchmarks/r4_dyngather_probe.py``, on a GPU.

P4: ``loop_iters`` wrapped row gathers from an ``(A, B)`` table, each row
summed in float32 (``take_along_axis`` with the index broadcast over a row
is a row gather), through :func:`~.pallas_probe.gather_sum`.  The three
calls of ``__main__`` are the JAX probe's: a cell_meta-shaped int32 table,
window rows of 384 float32, and narrow 8-float rows.

    python -m hare_tpu_torch.benchmarks.r4_dyngather_probe    # on a GPU host
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .pallas_probe import gather_sum, seconds_per_call

__all__ = ["CALLS", "probe", "probe_inputs"]

# The JAX probe's three calls (r4_dyngather_probe.py:82-86):
# (A, B, table dtype, loop_iters, label).
CALLS = (
    (110592, 2, np.int32, 32, "cell_meta (110592,2) i32"),
    (32768, 384, np.float32, 8, "win rows (32768,384) f32"),
    (32768, 8, np.float32, 32, "ctx rows (32768,8) f32"),
)


def probe_inputs(A: int, B: int, dtype) -> Tuple[np.ndarray, np.ndarray]:
    """The JAX probe's ``tab (A, B)`` of ``dtype`` and ``idx (A, 1)`` int32,
    both from one ``default_rng(0)``; an int32 table truncates the float32
    normals toward zero, as JAX's ``astype`` does."""
    rng = np.random.default_rng(0)
    tab = rng.normal(size=(A, B)).astype(np.float32).astype(dtype)
    idx = rng.integers(0, A, size=(A, 1)).astype(np.int32)
    return tab, idx


def probe(A: int, B: int, dtype, loop_iters: int, label: str, device="cuda") -> Tuple[float, float]:
    """Time ``loop_iters`` gathers of ``(A, B)`` rows on ``device``, print the
    JAX probe's line, and return ``(ms per call, ns per gathered row)``."""
    tab, idx = probe_inputs(A, B, dtype)
    tab = torch.from_numpy(tab).to(device)
    idx = torch.from_numpy(idx.reshape(-1)).to(device)
    dt = seconds_per_call(lambda: gather_sum(tab, idx, loop_iters, torch.float32), device)
    rows = A * loop_iters
    elems = rows * B
    print(
        f"{label}: {dt*1e3:.3f} ms for {loop_iters} gathers of "
        f"({A},{B}) -> {dt/rows*1e9:.2f} ns/row, "
        f"{elems/dt/1e9:.1f} Gelem/s"
    )
    return dt * 1e3, dt / rows * 1e9


if __name__ == "__main__":
    print("devices:", [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())])
    for call in CALLS:
        probe(*call)
