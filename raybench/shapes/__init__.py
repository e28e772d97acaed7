"""Scene shapes, one module a shape, each with ``faces(**args)`` returning
stacked ``(F, K, 3)`` float64 faces.  Frozen copies of the generators the
eval configurations use (the port's ``mesh/shapes.py``), so that a change
there cannot move the benchmark's scenes; ``digests.json`` holds them."""

from __future__ import annotations

import importlib
from typing import Dict, List, Sequence

import numpy as np


def faces(shape: str, args: Dict) -> np.ndarray:
    """The faces of shape ``shape`` (a module of this package) at ``args``."""
    if not shape.isidentifier():
        raise ValueError(f"bad shape name {shape!r}")
    return importlib.import_module(f"{__name__}.{shape}").faces(**args)


def scene(parts: Sequence[Dict]) -> List[np.ndarray]:
    """A configuration's ``scene``: one ``(F, K, 3)`` chunk a part, in order;
    each part is ``{"shape": name, "args": {...}}``."""
    return [faces(p["shape"], p.get("args", {})) for p in parts]
