"""The plain reference and the frozen counts, at tiny sizes on the CPU,
against the port's plain versions (which the reference itself never
imports)."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from raybench import counts, rays, reference, shapes  # noqa: E402

HALL = [{"shape": "concert_hall", "args": {"seed": 1}}]
SPHERES = [{"shape": "shoebox", "args": {"lx": 40.0, "ly": 40.0, "lz": 40.0}},
           {"shape": "icosphere", "args": {"subdiv": 3, "radius": 6.0, "center": [10.0, 10.0, 10.0]}}]


@pytest.mark.parametrize("parts", [HALL, SPHERES], ids=["hall", "shell_sphere"])
def test_coplanar_neighbours_match_the_ports_scene(parts):
    import hare_tpu_torch as th

    faces = shapes.scene(parts)
    sc = th.build_scene([th.Topology.build(faces)], device="cpu")
    tris, poly = reference.triangles(faces)
    got = reference.coplanar_neighbours(torch.from_numpy(tris), torch.from_numpy(poly))
    want = sc.tri_meta[: len(tris), 1:4].long()
    assert torch.equal(got, want)


def _port_trace(parts, accel, params, source, n, bounces, seed):
    import hare_tpu_torch as th

    faces = shapes.scene(parts)
    top = th.Topology.build(faces)
    sp = th.SpatialPartition(top, accel=accel, device="cpu", **params)
    d = rays.pool(seed, n, 1, "cpu")[0]
    o = torch.tensor(source, dtype=torch.float32).expand(n, 3).contiguous()
    a = torch.full((top.n_polys,), 0.3, requires_grad=True)
    res = th.trace_rays(sp.scene, th.Ray.make(o, d), a, bounces, sp.shoot_fn, aux=sp.aux)
    hist = th.energy_histogram(res, 256)
    (g,) = torch.autograd.grad(hist.sum(), a)
    return faces, o, d, a.detach(), res, hist.detach(), g


@pytest.mark.parametrize("parts,accel,params,source", [
    (HALL, "octree", {}, (15.0, 24.0, 8.0)),
    (SPHERES, "grid", {"domain": 16}, (20.0, 20.0, 20.0)),
], ids=["hall_octree", "shell_sphere_grid"])
def test_reference_traces_as_the_port(parts, accel, params, source):
    faces, o, d, a, res, hist, g = _port_trace(parts, accel, params, source, 384, 3, 7)
    sc = reference.build(faces, "cpu")
    ref = reference.trace(sc, o, d, a.double(), 3, 343.0)
    assert torch.equal(ref.hit, res.hit)
    assert torch.equal(ref.poly, res.poly_id.long())
    hit = ref.hit
    assert torch.allclose(ref.t[hit], res.t[hit].double(), rtol=1e-5, atol=1e-4)
    assert torch.allclose(ref.energy, res.energy.double(), rtol=1e-6)
    assert torch.allclose(ref.time[hit], res.time[hit].double(), rtol=1e-5)
    e, t, h, gr = reference.loss_and_grad(res.hit, res.poly_id, res.t, a.double(), 343.0, 256,
                                          1e-3)
    assert torch.allclose(h, hist.double(), rtol=1e-5, atol=1e-9)
    assert torch.allclose(gr, g.double(), rtol=1e-5, atol=1e-9)


def test_reference_in_bfloat16_departs():
    faces, o, d, a, res, hist, g = _port_trace(HALL, "octree", {}, (15.0, 24.0, 8.0), 256, 3, 8)
    low = reference.trace(reference.build(faces, "cpu", torch.bfloat16), o, d,
                          a.to(torch.bfloat16), 3, 343.0)
    assert (low.poly != res.poly_id.long()).any()


def test_counts_are_floors_of_the_ports_work():
    """The shape counts never exceed the port's own count of the work a
    step did (its plain walk's slots and node rows; K4's bytes with the
    tables; A3's with the triangles and vertices it reads), so a share
    against them cannot pass 100% where the port's count would not."""
    import hare_tpu_torch as th
    from hare_tpu_torch.accel.common import tally_rows, tally_runs
    from hare_tpu_torch.benchmarks import bounds

    faces = shapes.scene(HALL)
    top = th.Topology.build(faces)
    sp = th.SpatialPartition(top, accel="octree", device="cpu")
    n = 512
    d = rays.pool(3, n, 1, "cpu")[0]
    o = torch.tensor((15.0, 24.0, 8.0)).expand(n, 3).contiguous()
    with tally_runs() as runs, tally_rows() as rows:
        hr = sp.shoot(th.Ray.make(o, d))
    walk = bounds.walk_bound(n, runs, rows, sp.struct.win_ids, sp.struct.branch)
    assert counts.traverse_bound_ms(n, 1) <= walk["bound_ms"]
    k4 = bounds.bounce_step_bound(hr.poly_id)
    assert counts.bounce_bound_ms(n, 1) <= k4["bound_ms"]
    a3 = bounds.finalize_hits_bwd_bound(hr.tri_id, hr.hit, sp.scene.tri_meta)
    assert counts.finalize_bwd_bound_ms(n, 1) <= a3["bound_ms"]
    assert counts.FINALIZE_BWD_RAY_BYTES == bounds.FINALIZE_BWD_RAY_BYTES
    assert counts.FINALIZE_BWD_MISS_OPS == bounds.FINALIZE_BWD_OPS[False]
    assert counts.TRI_TEST_OPS == bounds.TRI_TEST_OPS["watertight"]
    assert counts.BOUNCE_IN_BYTES == bounds.BOUNCE_IN_BYTES
    assert counts.BOUNCE_OUT_BYTES == bounds.BOUNCE_OUT_BYTES
