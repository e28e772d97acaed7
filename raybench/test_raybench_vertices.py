"""The step differentiated w.r.t. the vertices, on the CPU at tiny sizes:
the reference's vertex gradient against finite differences and against the
port, the traffic keys' defaults at the step and the numbers every cell
took before them, and the check's verdicts on the vertex cell's limits:
sound runs pass, the control and the planted faults fail."""

import os
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from raybench import cells, harness, judge, program, rays, reference, shapes  # noqa: E402

QUIET = open(os.devnull, "w")
# A shoebox and a subdivision-1 icosphere: 92 triangles; the quads' variant
# splits the shoebox's six quads into two triangles of one polygon each.
ROOM = [{"shape": "shoebox", "args": {"lx": 20.0, "ly": 20.0, "lz": 20.0}},
        {"shape": "icosphere", "args": {"subdiv": 1, "radius": 5.0, "center": [9.0, 10.0, 11.0]}}]
SOURCE = (3.0, 4.0, 5.0)


def _room_faces(quads: bool):
    faces = shapes.scene(ROOM)
    if quads:
        from raybench.shapes import shoebox

        faces[0] = shoebox.quads(20.0, 20.0, 20.0)
    return faces


def _reference_hits(faces, n: int, bounces: int, seed: int):
    """The reference's own trace of ``n`` rays from ``SOURCE``, and its
    hit points worked out from its ``t``."""
    sc = reference.build(faces, "cpu")
    d = rays.pool(seed, n, 1, "cpu")[0].double()
    o = torch.tensor(SOURCE, dtype=torch.float64).expand(n, 3)
    a = torch.full((int(sc.poly.max()) + 1,), 0.3, dtype=torch.float64)
    tr = reference.trace(sc, o, d, a, bounces, 343.0)
    return o, d, a, tr


def test_reference_vertex_grad_matches_finite_differences():
    """The replay's autograd gradient of the soft first moment against
    central differences of the same replay (the hits held), float64; and
    the replay at the reference's own hits gives the trace's times."""
    faces = _room_faces(quads=False)
    mesh = reference.weld(faces, "cpu")
    o, d, a, tr = _reference_hits(faces, 256, 2, 5)
    point = torch.zeros(tr.hit.shape + (3,), dtype=torch.float64)  # one triangle a polygon
    times = reference.replay(mesh, mesh.vertices, o, d, tr.hit, tr.poly, point, 343.0).time
    assert torch.allclose(times[tr.hit], tr.time[tr.hit], rtol=1e-12, atol=0)

    args = (o, d, tr.hit, tr.poly, tr.t, point, a, 343.0, 128, 1e-3)
    g = reference.vertex_loss_and_grad(mesh, *args)[3]

    def loss(v):
        m = mesh._replace(vertices=v)
        energy, _ = reference.lanes(tr.hit, tr.poly, tr.t, a, 343.0)
        t = reference.replay(m, v, o, d, tr.hit, tr.poly, point, 343.0).time
        return float(reference.loss_of(reference.soft_histogram(energy, t, tr.hit, 128, 1e-3),
                                       True))

    scale = float(g.abs().max())
    assert scale > 0
    picks = torch.argsort(g.abs().reshape(-1), descending=True)[:12].tolist() + [0, 7, 50]
    eps = 1e-6
    for k in picks:
        i, c = divmod(k, 3)
        hi, lo = mesh.vertices.clone(), mesh.vertices.clone()
        hi[i, c] += eps
        lo[i, c] -= eps
        fd = (loss(hi) - loss(lo)) / (2 * eps)
        assert abs(fd - float(g[i, c])) <= 1e-6 * scale, (i, c, fd, float(g[i, c]))


@pytest.mark.parametrize("accel,params", [("kdtree", {"max_tris_per_node": 8}),
                                          ("grid", {"domain": 8})])
def test_reference_vertex_grad_matches_the_port(accel, params):
    """The port's CPU path (its plain versions, float32) against the
    reference's replay of its hits (float64), on a room of quads: the hit
    triangle of a quad is found from the point.  The vertex gradient agrees
    to 1e-5 of its largest entry, and each vertex to 1e-5 of its own scale
    (``judge.vertex_grad_gap``): the port's float32 rounding (about 6e-8
    an operation) is amplified by the plane's 1 / (n . d) at oblique hits,
    and its sums over the lanes that touch a vertex add more; these rays
    read 1e-7 to 4e-7 of the largest entry, 7e-7 of a vertex's scale."""
    import hare_tpu_torch as th

    faces = _room_faces(quads=True)
    top = th.Topology.build(faces)
    sp = th.SpatialPartition(top, accel=accel, device="cpu", **params)
    n = 384
    d = rays.pool(11, n, 1, "cpu")[0]
    o = torch.tensor(SOURCE).expand(n, 3).contiguous()
    a = torch.full((top.n_polys,), 0.3)
    v = sp.scene.vertices.clone().requires_grad_()
    res = th.trace_rays(sp.scene.with_vertices(v), th.Ray.make(o, d), a, 2, sp.shoot_fn,
                        aux=sp.aux)
    hist = th.energy_histogram(res, 128, 1e-3, soft=True)
    (g,) = torch.autograd.grad((hist * torch.arange(128.0)).sum(), v)

    mesh = reference.weld(faces, "cpu")
    e, t, h, g_ref, scale, _ = reference.vertex_loss_and_grad(mesh, o, d, res.hit, res.poly_id,
                                                          res.t, res.point.detach(), a.double(),
                                                          343.0, 128, 1e-3)
    perm = reference.match_vertices(mesh.vertices, v.detach())
    assert perm is not None
    assert bool(mesh.two.any())  # the quads' polygons take the point rule
    assert float((g[perm].double() - g_ref).abs().max()) <= 1e-5 * float(g_ref.abs().max())
    assert judge.vertex_grad_gap(g[perm], g_ref, scale, torch.ones_like(scale).bool()) <= 1e-5
    assert float(g_ref.abs().max()) > 0
    hit = res.hit
    assert torch.allclose(t[hit], res.time.detach()[hit].double(), rtol=1e-5)
    assert torch.allclose(h, hist.detach().double(), rtol=1e-4, atol=1e-6)


def test_match_vertices():
    mesh = reference.weld(_room_faces(quads=False), "cpu")
    v = mesh.vertices.float()
    perm_ = torch.randperm(v.shape[0], generator=torch.Generator().manual_seed(3))
    perm = reference.match_vertices(mesh.vertices, v[perm_])
    assert torch.equal(v[perm_][perm], v)
    moved = v[perm_].clone()
    moved[4, 1] += 1e-3
    assert reference.match_vertices(mesh.vertices, moved) is None
    assert reference.match_vertices(mesh.vertices, v[1:]) is None


def test_step_keys():
    assert cells.step_of({}) == cells.Step(False, False, False, False)
    assert cells.step_of({"loss": "sum of the hard histogram", "wrt": "absorption"}) == \
        cells.step_of({})
    assert cells.step_of({"histogram": "soft", "loss": "first_moment", "wrt": "vertices",
                          "remat": True}) == cells.Step(True, True, True, True)
    with pytest.raises(ValueError):
        cells.step_of({"histogram": "tent"})


# --- The defaults against the step and the numbers of the harness before
# the traffic keys (its program.System.step and judge.numbers, frozen here).

def _frozen_step(system, batch):
    th, sp = system.th, system.partition
    res = th.trace_rays(sp.scene, batch, system.absorption, system.bounces, sp.shoot_fn,
                        aux=sp.aux, sound_speed=system.sound_speed)
    hist = th.energy_histogram(res, system.bins, system.bin_dt)
    (grad,) = torch.autograd.grad(hist.sum(), system.absorption)
    return judge.StepOutputs(res.hit, res.poly_id, res.t, res.energy.detach(),
                             res.time.detach(), hist.detach(), grad)


def _frozen_loss_and_grad(hit, poly, t, absorption, sound_speed, bins, bin_dt):
    a = absorption.detach().clone().requires_grad_()
    with torch.enable_grad():
        energy, time_ = reference.lanes(hit, poly, t, a, sound_speed)
        h = reference.histogram(energy, time_, hit, bins, bin_dt)
        (g,) = torch.autograd.grad(h.sum(), a)
    return energy.detach(), time_.detach(), h.detach(), g


def _frozen_numbers(sc, origin, directions, absorption, out, sample, cfg, traffic):
    n_b, speed = traffic["bounces"], cfg["sound_speed"]
    bins, bin_dt = traffic["bins"], traffic["bin_dt"]
    idx = sample.to(directions.device)
    ref = reference.trace(sc, origin[idx], directions[idx], absorption.double(), n_b, speed)
    prog = reference.Trace(out.hit[:, idx], out.poly[:, idx], out.t[:, idx],
                           out.energy[:, idx], out.time[:, idx])
    same = (prog.hit == ref.hit) & (~ref.hit | (prog.poly.long() == ref.poly))
    both = torch.cumprod(same.long(), dim=0).bool() & ref.hit
    t_gap = judge._rel(prog.time, ref.time)[both]
    e_gap = judge._rel(prog.energy, ref.energy)[both]
    h = reference.histogram(prog.energy.double(), prog.time.double(), prog.hit, bins, bin_dt)
    h_ref = reference.histogram(ref.energy.double(), ref.time.double(), ref.hit, bins, bin_dt)
    got = {"path_mismatch": 1.0 - float(same.all(dim=0).double().mean()),
           "time_gap": judge._max(t_gap) if t_gap.numel() else float("inf"),
           "energy_gap": judge._max(e_gap) if e_gap.numel() else float("inf"),
           "sample_hist_gap": judge._cdf_gap(h, h_ref)}
    got.update(judge.lane_numbers(out, *_frozen_loss_and_grad(
        out.hit, out.poly, out.t, absorption.double(), speed, bins, bin_dt)))
    return got


SHELL = {"name": "shell_sphere_grid", "scene": [
    {"shape": "shoebox", "args": {"lx": 40.0, "ly": 40.0, "lz": 40.0}},
    {"shape": "icosphere", "args": {"subdiv": 3, "radius": 6.0, "center": [10.0, 10.0, 10.0]}}],
    "accel": "grid", "accel_params": {"domain": 16}, "kernel": "watertight", "dtype": "float32",
    "source": [20.0, 20.0, 20.0], "absorption": 0.3, "sound_speed": 343.0, "check_rays": 192}


def _hall_cell():
    cell = cells.resolve("c3_octree_32k_fwdbwd", ROOT)
    return cell._replace(traffic=dict(cell.traffic, rays_per_step=384, pool_batches=2,
                                      bounces=3),
                         config=dict(cell.config, check_rays=192))


def _shell_cell():
    cell = cells.resolve("c5_grid256_2p20_fwdbwd", ROOT)
    return cell._replace(traffic=dict(cell.traffic, rays_per_step=384, pool_batches=2),
                         config=SHELL)


@pytest.mark.parametrize("make", [_hall_cell, _shell_cell], ids=["hall", "shell"])
def test_defaults_give_the_numbers_of_before(make):
    cell = make()
    assert "histogram" not in cell.traffic and "remat" not in cell.traffic
    seed = 2**31 + 41
    s = harness.set_up(cell, seed, "cpu")
    assert s.system.vertices is None and s.system.weight is None
    out = s.system.step(s.batches[1])
    before = _frozen_step(s.system, s.batches[1])
    for name in judge.StepOutputs._fields[:7]:
        assert torch.equal(getattr(out, name), getattr(before, name)), name
    assert out.point is None and out.vertices is None  # nothing held past the step
    sc = reference.build(s.faces, "cpu")
    sample = rays.sample(seed, cell.traffic["rays_per_step"], cell.config["check_rays"])
    absorption = s.system.absorption.detach()
    args = (sc, s.origin, s.dirs[1], absorption, out, sample, cell.config, cell.traffic)
    assert judge.numbers(*args) == _frozen_numbers(*args)


# --- The vertex cell's limits at a tiny size: the same traffic and limits,
# a small scene of the same kinds (a 40 m shell, icospheres, an SAH KD
# tree with leaves of 8).

SMALL_SHELL = [{"shape": "shoebox", "args": {"lx": 40.0, "ly": 40.0, "lz": 40.0}},
               {"shape": "icosphere", "args": {"subdiv": 3, "radius": 6.0,
                                               "center": [12.0, 12.0, 12.0]}},
               {"shape": "icosphere", "args": {"subdiv": 2, "radius": 5.0,
                                               "center": [28.0, 28.0, 28.0]}}]


def _vertex_cell(**traffic):
    cell = cells.resolve("c4_kd650k_vertices_fwdbwd", ROOT)
    return cell._replace(traffic=dict(cell.traffic, rays_per_step=512, pool_batches=2, **traffic),
                         config=dict(cell.config, scene=SMALL_SHELL, check_rays=512))


@pytest.mark.parametrize("remat", [False, True])
def test_vertex_step_sound_runs_pass(remat):
    cell = _vertex_cell(remat=remat)
    r = harness.run(cell, 2**32 + 9, 0.1, False, "cpu", time.time(), report=QUIET)
    assert r["correct"] is True, r["checks"]
    # Each vertex's gap as a share of its own scale: 1e-5 to 2e-5 here.
    assert r["checks"]["grad_gap"]["value"] < 5e-5


def test_vertex_control_fails():
    """The reference in bfloat16 in the program's place fails the limits."""
    cell = _vertex_cell()
    rows = harness.control_run(cell, [31, 32, 33], "cpu", report=QUIET)
    for row in rows:
        assert judge.verdict(row["program"], cell.limits), row["program"]
        assert not judge.verdict(row["control"], cell.limits), row["control"]


def _broken(fault, monkeypatch):
    """Plant ``fault`` under the timed step."""
    from hare_tpu_torch.geom.math import dot
    from hare_tpu_torch.trace import bounce

    real = program.System.step
    if fault == "normal_in_gradient":  # the reflection's normal held constant
        monkeypatch.setattr(bounce, "reflect", lambda d, n: d - 2.0 * dot(
            d, n.detach())[..., None] * n.detach())
        return
    if fault == "normal_in_reflection":  # the reflection without its normal term
        monkeypatch.setattr(bounce, "reflect", lambda d, n: d + 0.0 * n)
        return
    if fault == "hard_bins":  # hard bins in the soft step's place
        monkeypatch.setattr(program.System, "__init__", _hard_init(program.System.__init__))
        return

    def step(self, batch):
        out = real(self, batch)
        n = out.hit.shape[1]
        keep = torch.arange(n) < n // 2  # half the batch left out, the rest counted twice
        return out._replace(hit=out.hit & keep, energy=out.energy * keep, hist=out.hist * 2,
                            grad=out.grad * 2)

    monkeypatch.setattr(program.System, "step", step)


def _hard_init(real_init):
    def init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        self.spec = self.spec._replace(soft=False)

    return init


@pytest.mark.parametrize("fault", ["normal_in_gradient", "normal_in_reflection", "hard_bins",
                                   "half"])
def test_vertex_planted_faults_fail(monkeypatch, fault):
    _broken(fault, monkeypatch)
    cell = _vertex_cell()
    r = harness.run(cell, 2**31 + 77, 0.1, False, "cpu", time.time(), report=QUIET)
    assert r["correct"] is False, r["checks"]
    if fault in ("normal_in_gradient", "hard_bins"):
        # forward as the sound step's: the vertex gradient's number catches it
        assert r["checks"]["grad_gap"]["value"] > r["checks"]["grad_gap"]["limit"]


def _vertex_step(seed: int):
    """The tiny vertex cell's set-up and one step, and the reference's
    replay of it: ``(cell, s, out, mesh, lanes, allowance, perm)``."""
    cell = _vertex_cell()
    s = harness.set_up(cell, seed, "cpu")
    out = s.system.step(s.batches[1])
    mesh = reference.weld(s.faces, "cpu")
    cfg, traffic = cell.config, cell.traffic
    lanes = reference.vertex_loss_and_grad(
        mesh, s.origin, s.dirs[1], out.hit, out.poly, out.t, out.point,
        s.system.absorption.detach(), cfg["sound_speed"], traffic["bins"], traffic["bin_dt"])
    _, allowance = judge.comparable(mesh, out.hit, lanes[1], lanes[5], traffic["bin_dt"])
    perm = reference.match_vertices(mesh.vertices, out.vertices)
    return cell, s, out, mesh, lanes, allowance, perm


def _numbers(cell, s, out, mesh, seed):
    cfg, traffic = cell.config, cell.traffic
    sc = reference.build(s.faces, "cpu")
    sample = rays.sample(seed, traffic["rays_per_step"], cfg["check_rays"])
    return judge.numbers(sc, s.origin, s.dirs[1], s.system.absorption.detach(), out, sample,
                         cfg, traffic, mesh)


@pytest.mark.parametrize("fault", ["key_dropped", "doubled", "to_neighbour", "times_1.1",
                                   "corner_doubled"])
def test_vertex_one_vertex_fault_fails(fault):
    """One sphere vertex's key dropped from the scatter, its gradient
    doubled, sent to a neighbour, or x 1.1 fails ``grad_gap``, and so does a
    shell corner's doubled; the sound step passes.  The sphere vertex is the
    median, by the share of its own scale that its gradient is, of those
    the check compares with no allowance.  (A
    0.1% change of one vertex is within the float32 program's own rounding
    of a vertex's gradient at the cell's size, up to 3.3e-3 of its scale:
    no limit that sound runs pass can see it.)"""
    seed = 2**31 + 78
    cell, s, out, mesh, lanes, allowance, perm = _vertex_step(seed)
    g_r, scale = lanes[3], lanes[4]
    wall = ((mesh.vertices == 0.0) | (mesh.vertices == 40.0)).all(dim=1)
    share = torch.linalg.vector_norm(g_r, dim=1) / scale.clamp_min(1e-300)
    picks = torch.nonzero((allowance == 0) & (scale > 0) & ~wall).reshape(-1)
    assert picks.numel() > 50
    v = int(picks[torch.argsort(share[picks])[picks.numel() // 2]])
    tri = mesh.tri_vid[(mesh.tri_vid == v).any(dim=1)][0]
    w = int(tri[tri != v][0])  # a neighbour: another corner of a triangle of v
    if fault == "corner_doubled":
        v = int(torch.where(wall, scale, 0.0).argmax())
    grad = out.grad.clone()
    if fault == "to_neighbour":
        grad[perm[w]] += grad[perm[v]]
        grad[perm[v]] = 0.0
    else:
        grad[perm[v]] *= {"key_dropped": 0.0, "times_1.1": 1.1}.get(fault, 2.0)
    sound = _numbers(cell, s, out, mesh, seed)
    broken = _numbers(cell, s, out._replace(grad=grad), mesh, seed)
    assert judge.verdict(sound, cell.limits), sound
    assert broken["grad_gap"] > cell.limits["grad_gap"], (broken["grad_gap"], float(share[v]))


def test_vertex_time_shift_fails():
    """A few lanes' arrival times one bin late (their gradient as the sound
    step's) fail the check: ``lane_gap`` reads them."""
    seed = 2**31 + 79
    cell, s, out, mesh, lanes, allowance, perm = _vertex_step(seed)
    lanes_hit = torch.nonzero(out.hit[1]).reshape(-1)[:4]
    time = out.time.clone()
    time[1, lanes_hit] += cell.traffic["bin_dt"]
    broken = _numbers(cell, s, out._replace(time=time), mesh, seed)
    assert broken["lane_gap"] > cell.limits["lane_gap"]
    assert not judge.verdict(broken, cell.limits)


def test_comparable_leaves_out_grazing_rays_and_bin_centres():
    """A ray that meets a triangle at a grazing angle is left out of
    ``lane_gap``; ``grad_gap`` allows each vertex of its triangles its term
    times ``GRAZING_COS / |cos|``, and each of a ray with a lane whose
    reference bin position lies within ``CENTRE_WINDOW`` of a bin centre
    (where the tent's clip halves the gradient of a float32 position that
    falls on it) its term.  The rule reads the reference alone."""
    mesh = reference.weld(_room_faces(quads=False), "cpu")
    n = 4
    hit = torch.ones(2, n, dtype=torch.bool)
    tri = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]])
    cos = torch.full((2, n), 0.5, dtype=torch.float64)
    cos[1, 1] = 0.5 * judge.GRAZING_COS
    time_r = torch.tensor([[0.0123, 0.0234, 0.0345005, 0.0451],
                           [0.0567, 0.0678, 0.0786, 0.0891]], dtype=torch.float64)
    term = torch.tensor([[1.0, 2.0, 3.0, 4.0], [5.0, 6.0, 7.0, 8.0]], dtype=torch.float64)
    rp = reference.Replay(time_r, tri, cos, None, term)
    rays, allowance = judge.comparable(mesh, hit, time_r, rp, 1e-3)
    assert rays.tolist() == [True, False, True, True]
    # Ray 2's first lane sits 5e-4 bins (1.5e-5 of its position) from a
    # centre: within the window; no other lane is.
    want = torch.zeros_like(allowance)
    for b in range(2):
        want.index_add_(0, mesh.tri_vid[tri[b, 1]], torch.full((3,), 2.0 * float(term[b, 1]),
                                                               dtype=torch.float64))
        want.index_add_(0, mesh.tri_vid[tri[b, 2]], torch.full((3,), float(term[b, 2]),
                                                               dtype=torch.float64))
    assert torch.equal(allowance, want)


def test_vertex_grad_gap_less_its_allowance():
    """A vertex's gap less its allowance, over its scale; an untouched vertex
    with a gradient reads infinite."""
    grad_r = torch.tensor([[1.0, 0.0, 0.0], [0.0, 2.0, 0.0], [0.0, 0.0, 0.0]], dtype=torch.float64)
    scale = torch.tensor([2.0, 4.0, 0.0], dtype=torch.float64)
    grad = grad_r.clone()
    grad[0, 0] = 1.5
    assert judge.vertex_grad_gap(grad, grad_r, scale, torch.zeros(3)) == 0.25
    assert judge.vertex_grad_gap(grad, grad_r, scale, torch.tensor([0.3, 0.0, 0.0], dtype=torch.float64)) == 0.1
    assert judge.vertex_grad_gap(grad, grad_r, scale, torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64)) == 0.0
    grad[2, 1] = 1e-9
    assert judge.vertex_grad_gap(grad, grad_r, scale, torch.zeros(3)) == float("inf")
