"""Structured JSONL metrics (``hare_tpu/utils/metrics.py``).

Per-step metrics of a sweep — rays/s, per-bounce live-lane occupancy,
histogram energy totals, gradient norms — as JSON lines any downstream tool
can read.
"""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Iterable, Mapping, Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["MetricsLogger", "trace_metrics"]


def trace_metrics(result) -> dict:
    """Summarize a :class:`~hare_tpu_torch.trace.TraceResult`: each bounce's
    occupancy (the share of lanes that hit), each bounce's energy, the total
    and the batch's shape."""
    hit = result.hit.detach().cpu().numpy()
    energy = result.energy.detach().cpu().numpy()
    return {
        "bounce_occupancy": hit.mean(axis=1).round(4).tolist(),
        "bounce_energy": energy.sum(axis=1).round(4).tolist(),
        "total_energy": float(energy.sum()),
        "n_rays": int(hit.shape[1]),
        "n_bounces": int(hit.shape[0]),
    }


class MetricsLogger:
    """Append-only JSONL metrics sink.

    >>> log = MetricsLogger("metrics.jsonl")
    >>> log.write(step=0, rays_per_s=1.2e6, loss=0.5)
    """

    def __init__(self, path: Optional[str] = None, stream: Optional[IO] = None):
        if path is not None:
            self._fh = open(path, "a", buffering=1)
            self._own = True
        else:
            self._fh = stream or sys.stderr
            self._own = False
        self._t0 = time.time()

    def write(self, **fields) -> dict:
        """One JSON line: the seconds since the logger opened, then each
        field; a tensor or array of more than 64 elements as its mean, min
        and max."""
        rec = {"t": round(time.time() - self._t0, 3)}
        for k, v in fields.items():
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            if hasattr(v, "tolist"):
                v = np.asarray(v)
                v = v.tolist() if v.size <= 64 else {
                    "mean": float(v.mean()),
                    "min": float(v.min()),
                    "max": float(v.max()),
                }
            rec[k] = v
        self._fh.write(json.dumps(rec) + "\n")
        return rec

    def grad_norms(self, grads: Union[Mapping[str, torch.Tensor],
                                      Iterable[Tuple[str, torch.Tensor]]], step: int) -> dict:
        """Log the 2-norm of each gradient: ``grads`` maps a name to a
        gradient tensor, or is ``model.named_parameters()`` (each parameter's
        ``.grad``; one without a gradient is left out)."""
        items = grads.items() if isinstance(grads, Mapping) else grads
        flat = {}
        for name, t in items:
            g = t.grad if isinstance(t, torch.nn.Parameter) or (
                isinstance(t, torch.Tensor) and t.requires_grad) else t
            if g is not None:
                flat[name] = float(torch.linalg.vector_norm(g.detach()))
        return self.write(step=step, grad_norms=flat)

    def close(self):
        if self._own:
            self._fh.close()
