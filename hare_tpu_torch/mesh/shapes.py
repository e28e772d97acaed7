"""Procedural test scenes (the reference ships none — SURVEY.md §4).

A NumPy copy of ``hare_tpu/mesh/shapes.py``; the tests hold the two equal.

These generators back the eval configs of BASELINE.json: the 12-triangle
shoebox room (config 1), a faceted "concert hall" (config 2/3), and random
triangle soups / subdivided spheres for property tests and large-scene
benchmarks (configs 4/5).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = ["shoebox", "shoebox_quads", "random_soup", "icosphere", "concert_hall"]


def shoebox(lx: float = 4.0, ly: float = 5.0, lz: float = 3.0) -> List[np.ndarray]:
    """A rectangular room as 12 triangles, normals facing inward.

    The canonical Pachyderm test scene: 6 quads split into triangles.
    """
    return [t for q in shoebox_quads(lx, ly, lz) for t in (q[[0, 1, 2]], q[[2, 3, 0]])]


def shoebox_quads(
    lx: float = 4.0, ly: float = 5.0, lz: float = 3.0
) -> List[np.ndarray]:
    """The same room as 6 quadrilaterals (exercises the quad path)."""
    c = np.array(
        [
            [0, 0, 0], [lx, 0, 0], [lx, ly, 0], [0, ly, 0],
            [0, 0, lz], [lx, 0, lz], [lx, ly, lz], [0, ly, lz],
        ],
        np.float64,
    )
    # Wound so normals point into the room interior.
    quads = [
        [0, 1, 2, 3],  # floor (z=0), normal +z
        [7, 6, 5, 4],  # ceiling (z=lz), normal -z
        [4, 5, 1, 0],  # y=0 wall, normal +y
        [6, 7, 3, 2],  # y=ly wall, normal -y
        [7, 4, 0, 3],  # x=0 wall, normal +x
        [5, 6, 2, 1],  # x=lx wall, normal -x
    ]
    return [c[q] for q in quads]


def random_soup(
    n: int, seed: int = 0, extent: float = 10.0, size: float = 0.8
) -> List[np.ndarray]:
    """n random triangles in a box — for accel-agreement property tests."""
    rng = np.random.default_rng(seed)
    center = rng.uniform(0, extent, (n, 1, 3))
    offs = rng.normal(0, size, (n, 3, 3))
    return list(center + offs)


def icosphere(subdiv: int = 3, radius: float = 1.0, center=(0.0, 0.0, 0.0)) -> List[np.ndarray]:
    """Subdivided icosahedron: 20 * 4**subdiv triangles (large-scene scaling)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ]
    )
    tris = verts[faces]  # (F, 3, 3)
    for _ in range(subdiv):
        a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
        ab, bc, ca = 0.5 * (a + b), 0.5 * (b + c), 0.5 * (c + a)
        for m in (ab, bc, ca):
            m /= np.linalg.norm(m, axis=1, keepdims=True)
        tris = np.concatenate(
            [
                np.stack([a, ab, ca], 1),
                np.stack([ab, b, bc], 1),
                np.stack([ca, bc, c], 1),
                np.stack([ab, bc, ca], 1),
            ]
        )
    tris = tris * radius + np.asarray(center)
    return list(tris)


def concert_hall(seed: int = 1) -> List[np.ndarray]:
    """A faceted hall (~5k tris): shoebox shell + stage + balconies + diffusers.

    Stands in for BASELINE.json config 2/3's "concert-hall mesh (~5k tris)".
    Deterministic for a given seed.
    """
    rng = np.random.default_rng(seed)
    faces: List[np.ndarray] = []
    faces += shoebox(30.0, 50.0, 18.0)

    def box(lo, hi):
        lo, hi = np.asarray(lo, float), np.asarray(hi, float)
        lx, ly, lz = hi - lo
        out = []
        for q in shoebox_quads(lx, ly, lz):
            q = q + lo
            out += [q[[0, 2, 1]], q[[2, 0, 3]]]  # flip: normals outward
        return out

    # Stage riser + reflector panels.
    faces += box([5, 1, 0], [25, 9, 1.2])
    for i in range(14):
        x0 = 5.5 + 1.4 * i
        faces += box([x0, 0.5, 14.0], [x0 + 1.0, 8.5, 14.3])
    # Side balconies.
    for side in (0.0, 28.5):
        for j in range(3):
            y0 = 12.0 + 12.0 * j
            faces += box([side, y0, 6.0], [side + 1.5, y0 + 9.0, 7.0])
    # Rear diffuser field: jittered pyramids on the back wall.
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
                faces.append(np.stack([b[k], b[(k + 1) % 4], apex]))
    # Seating blocks (coarse).
    for row in range(16):
        y0 = 12.0 + 2.2 * row
        faces += box([4.0, y0, 0.0], [26.0, y0 + 1.8, 0.8 + 0.05 * row])
    return faces
