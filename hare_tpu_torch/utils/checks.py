"""Numerical sanitizers and determinism checks (``hare_tpu/utils/checks.py``).

- :func:`enable_debug_checks`: autograd's anomaly mode (a backward op that
  makes a NaN raises, naming the forward op), and a flag that
  ``trace_rays``, ``energy_histogram`` and ``dist.make_train_step`` read to
  check their outputs with ``torch.isfinite``, raising
  ``FloatingPointError`` that names the stage.  With the flag off they add
  no check and no host synchronisation.
- :func:`determinism_check`: run a function several times and demand
  bitwise-equal results (one seed, one histogram).
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

from .tracing import sync

__all__ = ["check_finite", "debug_checks_enabled", "determinism_check", "enable_debug_checks"]

_DEBUG = {"nans": False, "infs": False}


def enable_debug_checks(nans: bool = True, infs: bool = False) -> None:
    """Raise on NaN (and, with ``infs``, on Inf) in the main path's outputs
    (:func:`check_finite`), and turn autograd's anomaly mode on (off when
    ``nans`` is False)."""
    _DEBUG["nans"], _DEBUG["infs"] = bool(nans), bool(infs)
    torch.autograd.set_detect_anomaly(bool(nans), check_nan=bool(nans))


def debug_checks_enabled() -> bool:
    return _DEBUG["nans"] or _DEBUG["infs"]


def check_finite(stage: str, *tensors: torch.Tensor) -> None:
    """With :func:`enable_debug_checks` on, raise ``FloatingPointError``
    naming ``stage`` where a float tensor holds a NaN (or, with ``infs``,
    an Inf).  Reads each tensor to the host, so a synchronisation (the
    span ``hare.sync``, site ``check_finite``); does nothing, and reads
    nothing, when the checks are off."""
    if not debug_checks_enabled():
        return
    for t in tensors:
        if t is None or not t.is_floating_point():
            continue
        t = t.detach()
        with sync("check_finite"):
            nan = _DEBUG["nans"] and bool(torch.isnan(t).any())
            inf = _DEBUG["infs"] and bool(torch.isinf(t).any())
        if nan:
            raise FloatingPointError(f"{stage}: NaN in an output")
        if inf:
            raise FloatingPointError(f"{stage}: Inf in an output")


def _leaves(x: Any, path: str, out: List[Tuple[str, Any]]) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs of nested tuples, NamedTuples, dicts and
    lists, in order; a NamedTuple's leaves are named by field."""
    if isinstance(x, dict):
        for k in x:
            _leaves(x[k], f"{path}/{k}", out)
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        for k in x._fields:
            _leaves(getattr(x, k), f"{path}/{k}", out)
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            _leaves(v, f"{path}[{i}]", out)
    else:
        out.append((path or "result", x))
    return out


def _host(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x if x is None else np.asarray(x)


def determinism_check(fn: Callable, *args, runs: int = 2) -> bool:
    """True iff ``fn(*args)`` is bitwise identical across ``runs`` calls
    (NaNs equal to NaNs, ``np.array_equal(..., equal_nan=True)``).

    Raises AssertionError naming the first differing leaf and the largest
    difference otherwise.
    """
    ref = [(p, _host(x)) for p, x in _leaves(fn(*args), "", [])]
    for r in range(1, runs):
        out = [(p, _host(x)) for p, x in _leaves(fn(*args), "", [])]
        if [p for p, _ in out] != [p for p, _ in ref]:
            raise AssertionError(f"nondeterminism: the result's structure differs on run {r}")
        for (path, a), (_, b) in zip(ref, out):
            if a is None or b is None:
                if a is not b:
                    raise AssertionError(f"nondeterminism: leaf {path} is None on one run ({r})")
                continue
            nan_ok = a.dtype.kind in "fc"
            if a.shape != b.shape or not np.array_equal(a, b, equal_nan=nan_ok):
                diff = (np.max(np.abs(a.astype(np.float64) - b.astype(np.float64)))
                        if a.shape == b.shape and a.size else "shape")
                raise AssertionError(
                    f"nondeterminism: leaf {path} differs on run {r} (max abs diff {diff})")
    return True
