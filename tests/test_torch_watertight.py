"""Watertightness on the port's other backends: ``tests/test_watertight.py``
on brute, octree, kdtree and kdtree_ropes (the grid's twin is
``tests/test_torch_geom.py::test_grid_no_cracks_parity``).

Rays from the centre of a closed icosphere aimed exactly at the midpoints
of its shared edges, and at its welded vertices, must all hit: the
watertight triangle test gives two triangles that share an edge edge
functions of consistent sign, so one of them (or both, at one t) takes any
ray through the edge.  Each hit is the port grid's triangle, another that
holds the aimed edge or vertex at the grid's t, or the float64 oracle's.  The JAX package's side is ``tests/test_watertight.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import hare_tpu_torch as th  # noqa: E402
from hare_tpu_torch.mesh import shapes  # noqa: E402
from hare_tpu_torch.oracle import oracle_shoot  # noqa: E402

# The port's entry points place tensors on "cuda" unless told otherwise;
# these tests run the plain versions on the CPU.
CPU = "cpu"

ACCELS = ("brute", "octree", "kdtree", "kdtree_ropes")
# A chord midpoint lies inside the circumscribed sphere: t at most a hair
# beyond the radius, and for edge rays at least 0.98 of it
# (tests/test_watertight.py:46).
T_OVER, EDGE_T_UNDER = 1e-3, 0.98
# Where a backend's triangle is not the grid's, the two tie at the aimed
# edge or vertex: B1 reads edges as differences of f32 corners, the grid's
# windows f64 differences rounded once (ROADMAP.md Queue C), so the t of
# each triangle through the shared feature differs by an ulp and the tie
# goes either way.  Such a triangle holds the aimed edge or vertex and its
# t is the grid's within TIE_T; any other must be the float64 oracle's.
TIE_T = 1e-5


def targets(target):
    """``(topology, radius, aim points, each aim's vertices)``: shared-edge
    midpoints of icosphere(3, r=2) (two vertices each), or the welded
    vertices of icosphere(2, r=1.5) (one each)."""
    if target == "edges":
        top, radius = th.Topology.build(shapes.icosphere(3, radius=2.0)), 2.0
        shared = np.array([len(p) >= 2 for p in top.edge_polys])
        feature = top.edges[shared]
        aim = 0.5 * (top.vertices[feature[:, 0]] + top.vertices[feature[:, 1]])
    else:
        top, radius = th.Topology.build(shapes.icosphere(2, radius=1.5)), 1.5
        aim, feature = top.vertices, np.arange(top.n_vertices)[:, None]
    return top, radius, aim.astype(np.float32), feature


@pytest.mark.parametrize("target", ["edges", "vertices"])
@pytest.mark.parametrize("accel", ACCELS)
def test_no_cracks(accel, target):
    top, radius, aim, feature = targets(target)
    d = aim / np.linalg.norm(aim, axis=1, keepdims=True)
    o = np.zeros_like(d)
    rays = th.Ray.make(torch.from_numpy(o), torch.from_numpy(d))
    hr = th.SpatialPartition(top, accel=accel, device=CPU).shoot(rays)
    missed = int((~hr.hit).sum())
    assert missed == 0, f"{accel}: {missed}/{len(d)} {target} rays missed"
    t = hr.t.numpy()
    assert (t <= radius * (1 + T_OVER)).all()
    if target == "edges":
        assert (t >= radius * EDGE_T_UNDER).all()
    grid = th.SpatialPartition(top, accel="grid", device=CPU).shoot(rays)
    assert bool(grid.hit.all())
    for i in np.flatnonzero(hr.tri_id.numpy() != grid.tri_id.numpy()):
        tri = int(hr.tri_id[i])
        tie = (set(feature[i]) <= set(top.tri_v[tri].tolist())
               and abs(t[i] - float(grid.t[i])) <= TIE_T * t[i])
        if not tie:
            ref = oracle_shoot(top, o[i], d[i])
            assert ref is not None and tri == ref["tri_id"], (
                f"{accel} ray {i}: tri {tri}, grid {int(grid.tri_id[i])}, oracle "
                f"{None if ref is None else ref['tri_id']}")
