"""A faceted hall, 1,608 triangles: a 30 x 50 x 18 m shell, a stage riser,
14 reflector panels, 6 side balconies, 288 pyramid diffusers on the back
wall and 16 seating blocks (eval configs 2, 3 and ``deep``)."""

from __future__ import annotations

import numpy as np

from . import shoebox


def _box(lo, hi) -> list:
    """A box's 12 triangles, normals outward."""
    lo, hi = np.asarray(lo, float), np.asarray(hi, float)
    lx, ly, lz = hi - lo
    out = []
    for q in shoebox.quads(lx, ly, lz):
        q = q + lo
        out += [q[[0, 2, 1]], q[[2, 0, 3]]]
    return out


def faces(seed: int = 1) -> np.ndarray:
    """``(1608, 3, 3)``; the diffusers' depths come from
    ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    out = list(shoebox.faces(30.0, 50.0, 18.0))
    out += _box([5, 1, 0], [25, 9, 1.2])
    for i in range(14):
        x0 = 5.5 + 1.4 * i
        out += _box([x0, 0.5, 14.0], [x0 + 1.0, 8.5, 14.3])
    for side in (0.0, 28.5):
        for j in range(3):
            y0 = 12.0 + 12.0 * j
            out += _box([side, y0, 6.0], [side + 1.5, y0 + 9.0, 7.0])
    nx, nz = 24, 12
    for ix in range(nx):
        for iz in range(nz):
            cx = 1.0 + ix * 28.0 / nx
            cz = 2.0 + iz * 14.0 / nz
            w = 0.5
            depth = 0.3 + 0.4 * rng.random()
            apex = np.array([cx + w / 2, 50.0 - depth, cz + w / 2])
            b = [
                np.array([cx, 50.0, cz]),
                np.array([cx + w, 50.0, cz]),
                np.array([cx + w, 50.0, cz + w]),
                np.array([cx, 50.0, cz + w]),
            ]
            for k in range(4):
                out.append(np.stack([b[k], b[(k + 1) % 4], apex]))
    for row in range(16):
        y0 = 12.0 + 2.2 * row
        out += _box([4.0, y0, 0.0], [26.0, y0 + 1.8, 0.8 + 0.05 * row])
    return np.stack(out)
