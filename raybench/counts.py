"""The least time an H100 could take for a layer's work, reckoned from the
cell's shapes alone: the yardstick of the ``*_roofline_pct`` metrics.

A bound is the larger of the operations over the peak FP32 rate and the
bytes over the peak memory rate, with each input byte read once and each
output byte written once.  The counts never look at the program's
structure (grid cells, tree nodes, window slots): they are what the
inputs need, so one count serves whatever grid or tree implements a layer.

Frozen from the port's ``benchmarks/bounds.py`` (its byte and operation
constants for the ray, the nearest hit, the triangle test, K4 and A3), with
the traversal's count reckoned anew from shapes.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet): FP32
# outside the tensor cores, and HBM3.
PEAK_FP32 = 67e12  # operations / s
PEAK_BYTES = 3.35e12  # bytes / s

# One ray as a traversal reads it: origin, direction (f32) and its two
# excluded polygons (i32); its nearest hit as it writes it: t (f32) and
# the triangle (i32).
RAY_BYTES = 12 + 12 + 8
NEAREST_BYTES = 4 + 4
# The hit triangle's geometry: v0 | e1 | e2, nine f32.
TRI_GEOM_BYTES = 36
# One watertight ray / triangle test, t only (bounds.py's count of
# csrc/intersect.cuh): 43 operations.
TRI_TEST_OPS = 43

# K4 forward per ray (bounds.py's BOUNCE_IN_BYTES, BOUNCE_OUT_BYTES and
# BOUNCE_OPS without scattering): the state (energy, dist, origin,
# direction, alive) and the hit record as the step reads it (hit, t, u, v,
# point, normal, poly_id, edge_nbr) in; the next state (origin, direction,
# exclude, energy, dist, live) and the outputs energy, time, poly_id and t
# out.  The polygons' absorption entries are left out: the bound is a floor.
BOUNCE_IN_BYTES = (4 + 4 + 12 + 12 + 1) + (1 + 4 + 4 + 4 + 12 + 12 + 4 + 12)
BOUNCE_OUT_BYTES = (12 + 12 + 8 + 4 + 4 + 1) + (4 + 4 + 4 + 4)
BOUNCE_OPS = 28

# A3, the hit record's backward, per ray (bounds.py's FINALIZE_BWD_RAY_BYTES
# and its miss ray's FINALIZE_BWD_OPS): the winner, the forward t, hit,
# origin, direction and the cotangents in; d(origin), d(direction), three
# vertex ids and three corner cotangents out; e1, e2 and the normal's two
# crosses.  A hit ray's further operations and the triangles' vertex ids
# and vertices read are left out: the bound is a floor.
FINALIZE_BWD_RAY_BYTES = (4 + 4 + 1 + 24 + 12 + 24) + (24 + 12 + 36)
FINALIZE_BWD_MISS_OPS = 6 + 18


def bound_ms(ops: float, nbytes: float) -> float:
    """The larger of ``ops / PEAK_FP32`` and ``nbytes / PEAK_BYTES``, in ms."""
    return max(ops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3


def traverse_bound_ms(rays: int, bounces: int) -> float:
    """A step's traversals: each bounce, every ray read once, its hit
    triangle's geometry read once for it, its nearest hit written once, and
    one triangle test."""
    shots = rays * bounces
    return bound_ms(shots * TRI_TEST_OPS, shots * (RAY_BYTES + TRI_GEOM_BYTES + NEAREST_BYTES))


def bounce_bound_ms(rays: int, bounces: int) -> float:
    """A step's K4 forwards: each bounce, every ray's state and record in,
    its next state and outputs out."""
    shots = rays * bounces
    return bound_ms(shots * BOUNCE_OPS, shots * (BOUNCE_IN_BYTES + BOUNCE_OUT_BYTES))


def finalize_bwd_bound_ms(rays: int, bounces: int) -> float:
    """A step's A3 launches: each bounce, every ray's record and cotangents
    in and its corner cotangents out, and a miss ray's operations."""
    shots = rays * bounces
    return bound_ms(shots * FINALIZE_BWD_MISS_OPS, shots * FINALIZE_BWD_RAY_BYTES)
