"""The program's spans and counters (``hare_tpu_torch.utils.tracing``), on
the CPU: the off path records nothing and touches neither the clock nor the
profiler; the spans of set-up, of a trace and of its backward nest as the
phases do and carry their request's id; the profiler's trace holds them
under the same names; the launch counter counts in ``kernels.build.launch``.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import hare_tpu_torch as th  # noqa: E402
from hare_tpu_torch.kernels import build  # noqa: E402
from hare_tpu_torch.mesh import shapes  # noqa: E402
from hare_tpu_torch.utils import checks, tracing  # noqa: E402

# The port's entry points place tensors on "cuda" unless told otherwise;
# these tests run the plain versions on the CPU.
CPU = "cpu"

TOPOLOGY_PARTS = ("weld", "polys", "planes", "edges")
BACKWARD = ("hare.backward.bounce_step", "hare.backward.histogram", "hare.backward.scatter")


@pytest.fixture
def rec():
    """Recording on, from nothing; off and empty again after."""
    tracing.reset()
    tracing.enable()
    yield tracing
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def room():
    """A shoebox with an icosphere inside: its faces and topology."""
    faces = shapes.shoebox(4, 5, 3) + shapes.icosphere(1, radius=0.7, center=(2.0, 3.5, 1.2))
    return faces, th.Topology.build(faces)


def rays_of(n, seed=0):
    rng = np.random.default_rng(seed)
    o = torch.tensor(rng.uniform((0.5, 0.5, 0.5), (3.5, 4.5, 2.5), (n, 3)), dtype=torch.float32)
    d = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32)
    return th.Ray.make(o, d)


def step(top, accel, n=48, bounces=3, remat=False, **params):
    """trace_rays, the hard histogram and its sum's gradient w.r.t. the
    absorption, on the CPU."""
    sp = th.SpatialPartition(top, accel=accel, device=CPU, **params)
    a = torch.full((top.n_polys,), 0.3, requires_grad=True)
    res = th.trace_rays(sp.scene, rays_of(n), a, bounces, sp.shoot_fn, aux=sp.aux, remat=remat)
    th.energy_histogram(res, 64).sum().backward()
    return a.grad


def by_seq(spans):
    return {s.seq: s for s in spans}


def children(spans, parent):
    return [s for s in spans if s.parent == parent.seq]


def named(spans, name):
    return [s for s in spans if s.name == name]


def test_off_records_nothing_and_opens_no_record_function(room, monkeypatch):
    """Recording off: a whole step records no span and opens no
    record_function, even under torch.profiler; the counters still count."""
    def refuse(*a, **k):
        raise AssertionError("record_function opened while recording is off")

    monkeypatch.setattr(tracing, "_record_function", refuse)
    tracing.disable()
    tracing.reset()
    _, top = room
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        step(top, "octree")
    snap = tracing.snapshot()
    assert snap.spans == []
    assert snap.counters["rays.shot"] == 48 * 3
    tracing.reset()


def test_off_span_is_one_shared_object_and_reads_no_clock(monkeypatch):
    """The off path returns the same object for every name and attribute,
    whose enter and exit do nothing, and reads no clock."""
    def no_clock():
        raise AssertionError("a clock was read while recording is off")

    monkeypatch.setattr(tracing.time, "perf_counter_ns", no_clock)
    tracing.disable()
    first = tracing.span("hare.bounce", b=1)
    assert tracing.span("hare.trace_rays") is first
    assert tracing.sync("tree_flag") is first
    with first as got:
        with tracing.span("hare.shoot"):
            assert got is first
            assert tracing.current_id() is None
    assert tracing.snapshot().spans == []
    tracing.reset()


def test_spans_nest_by_thread_and_carry_ids(rec):
    """Parents come from the thread's own stack; a span takes its parent's
    id, or its own seq at the top, or the id it is given, as a span opened
    on another thread for a request is."""
    got = {}

    def worker(rid):
        with rec.span("w.outer", id=rid):
            with rec.span("w.inner"):
                got["inner_id"] = rec.current_id()

    with rec.span("a") as a:
        with rec.span("a.b", k=1):
            t = threading.Thread(target=worker, args=(rec.current_id(),))
            t.start()
            t.join()
    spans = rec.snapshot().spans
    s = {x.name: x for x in spans}
    assert s["a"].parent is None and s["a"].attrs["id"] == s["a"].seq == a.seq
    assert s["a.b"].parent == s["a"].seq and s["a.b"].attrs == {"k": 1, "id": s["a"].seq}
    assert s["w.outer"].parent is None and s["w.outer"].thread != s["a"].thread
    assert s["w.outer"].attrs["id"] == s["a"].seq == got["inner_id"]
    assert s["w.inner"].parent == s["w.outer"].seq and s["w.inner"].attrs["id"] == s["a"].seq
    for x in spans:
        assert x.start_ns <= x.end_ns
        if x.parent is not None:
            p = by_seq(spans)[x.parent]
            assert p.start_ns <= x.start_ns and x.end_ns <= p.end_ns


def test_autograd_backward_spans_carry_the_forward_id(rec):
    """A Function's backward, run by autograd outside the forward's span,
    opens its spans under the id its forward kept on ctx."""
    class Twice(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            ctx.trace_id = rec.current_id()
            return 2 * x

        @staticmethod
        def backward(ctx, g):
            with rec.span("hare.backward.twice", id=ctx.trace_id):
                return 2 * g

    x = torch.ones(3, requires_grad=True)
    with rec.span("fwd") as f:
        y = Twice.apply(x).sum()
    y.backward()
    bwd = named(rec.snapshot().spans, "hare.backward.twice")
    assert len(bwd) == 1 and bwd[0].attrs["id"] == f.seq and bwd[0].parent is None


def test_topology_build_records_its_parts(rec, room):
    faces, _ = room
    top = th.Topology.build(faces)
    spans = rec.snapshot().spans
    (whole,) = named(spans, "hare.setup.topology")
    assert [s.name for s in children(spans, whole)] == [
        f"hare.setup.topology.{p}" for p in TOPOLOGY_PARTS]
    assert top.n_polys > 0


@pytest.mark.parametrize("accel", ["brute", "grid", "octree", "kdtree", "kdtree_ropes"])
def test_partition_records_scene_and_structure(rec, room, accel):
    _, top = room
    th.SpatialPartition(top, accel=accel, device=CPU)
    spans = rec.snapshot().spans
    assert len(named(spans, "hare.setup.scene")) == 1
    structs = named(spans, "hare.setup.structure")
    if accel == "brute":  # no structure
        assert structs == []
        return
    (st,) = structs
    assert st.attrs["accel"] == accel
    assert [s.name for s in children(spans, st)] == [
        "hare.setup.structure.tables", "hare.setup.structure.upload"]


def test_per_topology_grid_records_its_structure(rec):
    """The grid a filtered shoot builds lazily is a structure of set-up."""
    tops = [th.Topology.build(shapes.shoebox(4, 5, 3)),
            th.Topology.build(shapes.icosphere(1, radius=0.7, center=(2.0, 3.5, 1.2)))]
    sp = th.SpatialPartition(tops, device=CPU)
    rec.reset()
    sp.shoot(rays_of(16), top_index=1)
    spans = rec.snapshot().spans
    (st,) = named(spans, "hare.setup.structure")
    assert st.attrs["accel"] == "grid" and st.parent is None


@pytest.mark.parametrize("accel", ["brute", "grid", "octree", "kdtree_ropes"])
def test_trace_rays_spans_and_counters(rec, room, accel):
    """One hare.trace_rays holding three hare.bounce (b = 0, 1, 2), each a
    hare.shoot (hare.traverse, then hare.finalize) and a hare.bounce_step,
    all under the request's id; the backward's spans under it too;
    rays.shot N x 3; no launch and no sync on the CPU."""
    _, top = room
    n = 48
    params = {"domain": 4} if accel == "grid" else {}
    sp = th.SpatialPartition(top, accel=accel, device=CPU, **params)
    rec.reset()
    a = torch.full((top.n_polys,), 0.3, requires_grad=True)
    res = th.trace_rays(sp.scene, rays_of(n), a, 3, sp.shoot_fn, aux=sp.aux)
    th.energy_histogram(res, 64).sum().backward()
    snap = rec.snapshot()
    spans = snap.spans
    (req,) = named(spans, "hare.trace_rays")
    rid = req.attrs["id"]
    assert req.parent is None
    bounces = children(spans, req)
    assert [(s.name, s.attrs["b"]) for s in bounces] == [("hare.bounce", b) for b in range(3)]
    for b in bounces:
        assert [s.name for s in children(spans, b)] == ["hare.shoot", "hare.bounce_step"]
        (shoot,) = named(children(spans, b), "hare.shoot")
        parts = children(spans, shoot)
        assert [s.name for s in parts] == ["hare.traverse", "hare.finalize"]
        assert parts[0].attrs["accel"] == {"kdtree_ropes": "ropes", "octree": "tree"}.get(
            accel, accel)
    for s in spans:
        if s.name.startswith(("hare.bounce", "hare.shoot", "hare.traverse", "hare.finalize")):
            assert s.attrs["id"] == rid
    (hist,) = named(spans, "hare.histogram")
    assert hist.attrs["soft"] is False
    for name in BACKWARD:
        assert named(spans, name), name
    for s in named(spans, "hare.backward.bounce_step"):
        assert s.attrs["id"] == rid
    for s in named(spans, "hare.backward.histogram"):
        assert s.attrs["id"] == hist.attrs["id"] and s.attrs["soft"] is False
    assert len(named(spans, "hare.backward.bounce_step")) == 3
    assert snap.counters == {"rays.shot": n * 3}


def test_remat_recompute_opens_its_own_bounces(rec, room):
    """Under remat the backward shoots each bounce again: three more
    hare.bounce, each with its index and the forward's id."""
    _, top = room
    sp = th.SpatialPartition(top, accel="grid", device=CPU, domain=4)
    rec.reset()
    a = torch.full((top.n_polys,), 0.3, requires_grad=True)
    res = th.trace_rays(sp.scene, rays_of(32), a, 3, sp.shoot_fn, aux=sp.aux, remat=True)
    th.energy_histogram(res, 64).sum().backward()
    snap = rec.snapshot()
    (req,) = named(snap.spans, "hare.trace_rays")
    bounces = named(snap.spans, "hare.bounce")
    assert len(bounces) == 6 and {s.attrs["id"] for s in bounces} == {req.attrs["id"]}
    outside = [s for s in bounces if s.parent != req.seq]
    assert sorted(s.attrs["b"] for s in outside) == [0, 1, 2]
    assert snap.counters["rays.shot"] == 32 * 6


def test_vertex_gradient_records_the_finalize_backward(rec, room):
    """A soft-histogram loss w.r.t. the vertices runs A3's plain version
    under hare.backward.finalize, its scatter inside it."""
    _, top = room
    sp = th.SpatialPartition(top, accel="grid", device=CPU, domain=4)
    v = sp.scene.vertices.clone().requires_grad_()
    scene = sp.scene.with_vertices(v)
    a = torch.full((top.n_polys,), 0.3)
    rec.reset()
    with rec.span("fit") as fit:
        res = th.trace_rays(scene, rays_of(32), a, 2, sp.shoot_fn, aux=sp.aux)
        loss = (th.energy_histogram(res, 64, soft=True) * torch.arange(64.0)).sum()
    loss.backward()
    spans = rec.snapshot().spans
    fin = named(spans, "hare.backward.finalize")
    assert len(fin) == 2 and {s.attrs["id"] for s in fin} == {fit.seq}
    for f in fin:
        assert "hare.backward.scatter" in [s.name for s in children(spans, f)]
    assert [s.attrs["soft"] for s in named(spans, "hare.backward.histogram")] == [True]
    assert v.grad is not None


def test_debug_checks_are_sync_sites(rec, room):
    """With the debug checks on, each finite-check read is a hare.sync at
    site check_finite, counted."""
    _, top = room
    checks.enable_debug_checks()
    try:
        step(top, "brute", n=16, bounces=2)
    finally:
        checks.enable_debug_checks(False)
    snap = rec.snapshot()
    syncs = named(snap.spans, "hare.sync")
    assert syncs and {s.attrs["site"] for s in syncs} == {"check_finite"}
    assert snap.counters["syncs.check_finite"] == len(syncs)


def test_profiler_holds_the_spans_with_their_nesting(rec, room):
    """Under torch.profiler (CPU activity) each recorded span is also a
    profiler event of the same name, and the events nest as the spans."""
    _, top = room
    sp = th.SpatialPartition(top, accel="octree", device=CPU)
    rec.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        a = torch.full((top.n_polys,), 0.3, requires_grad=True)
        res = th.trace_rays(sp.scene, rays_of(32), a, 3, sp.shoot_fn, aux=sp.aux)
        th.energy_histogram(res, 64).sum().backward()
    spans = rec.snapshot().spans
    events = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("hare.")]
    assert sorted(e.name() for e in events) == sorted(s.name for s in spans)

    def holder(e, name):
        return [p for p in events if p.name() == name and p.start_thread_id() ==
                e.start_thread_id() and p.start_ns() <= e.start_ns() and e.end_ns() <= p.end_ns()]

    for e in events:
        if e.name() == "hare.bounce":
            assert len(holder(e, "hare.trace_rays")) == 1
        elif e.name() in ("hare.shoot", "hare.bounce_step"):
            assert len(holder(e, "hare.bounce")) == 1
        elif e.name() in ("hare.traverse", "hare.finalize"):
            assert len(holder(e, "hare.shoot")) == 1
    tracing.disable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(top, "octree", n=16, bounces=1)
    assert not [e for e in prof.profiler.kineto_results.events() if e.name().startswith("hare.")]


class _FakeLibrary:
    """Stands in for the kernel library: every entry point returns 0."""

    def __getattr__(self, name):
        return lambda *args: 0


def test_launch_counts_by_entry_point(monkeypatch):
    """kernels.build.launch counts each call under launches.<entry point>;
    the host-only plan under calls.hare_scatter_plan."""
    monkeypatch.setattr(build, "library", lambda: _FakeLibrary())
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda dev: 0, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    tracing.reset()
    for _ in range(3):
        build.launch("hare_grid_shoot", 1, 2)
    build.launch("hare_histogram_bwd")
    build.launch("hare_scatter_plan", 5, 7, None)
    assert tracing.snapshot().counters == {
        "launches.hare_grid_shoot": 3, "launches.hare_histogram_bwd": 1,
        "calls.hare_scatter_plan": 1}
    assert tracing.snapshot().spans == []
    tracing.reset()
    assert tracing.snapshot().counters == {}


def test_histogram_bwd_counts_its_mode_beside_its_launch(monkeypatch):
    """K3's backward counts its hard or soft mode where it launches
    hare_histogram_bwd, so the modes add up to the entry point's launches."""
    from hare_tpu_torch.trace import bounce

    monkeypatch.setattr(build, "library", lambda: _FakeLibrary())
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda dev: 0, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    energy, time = torch.ones(8), torch.linspace(0.0, 0.1, 8)
    hit, grad = torch.ones(8, dtype=torch.bool), torch.ones(16)
    tracing.reset()
    bounce._histogram_bwd_kernel(None, time, hit, grad, 16, 0.01, False)
    for _ in range(2):
        bounce._histogram_bwd_kernel(energy, time, hit, grad, 16, 0.01, True)
    assert tracing.snapshot().counters == {
        "launches.hare_histogram_bwd": 3, "histogram_bwd.hard": 1, "histogram_bwd.soft": 2}
    tracing.reset()


def test_spanned_puts_each_call_in_one_span(rec):
    """spanned(name) keeps the function's name and docstring, returns its
    result, and records one span a call around the spans it opens."""

    @tracing.spanned("w.call")
    def work(x, y=1):
        """Adds."""
        with tracing.span("w.inner"):
            return x + y

    assert work.__name__ == "work" and work.__doc__ == "Adds." and work(2, y=3) == 5
    assert work(1) == 2
    spans = rec.snapshot().spans
    calls = named(spans, "w.call")
    assert len(calls) == 2 and all(s.parent is None for s in calls)
    assert [children(spans, s)[0].name for s in calls] == ["w.inner", "w.inner"]
    rec.disable()
    rec.reset()
    assert work(4) == 5 and rec.snapshot().spans == []
