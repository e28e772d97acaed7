"""Port parity: the utilities (config, metrics, checkpoint, checks, timing)
against the JAX package's ``hare_tpu.utils``.

Mirrors ``tests/test_utils.py`` on the port: the same NumPy inputs made from
a seed; the JAX side runs on the CPU that conftest pins.
"""

import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import hare_tpu as jh  # noqa: E402
from hare_tpu.mesh import shapes as jshapes  # noqa: E402
from hare_tpu.utils import HareConfig as JHareConfig  # noqa: E402
from hare_tpu.utils import trace_metrics as j_trace_metrics  # noqa: E402

import hare_tpu_torch as th  # noqa: E402
from hare_tpu_torch.convert import (  # noqa: E402
    grid_from_numpy,
    ropes_from_numpy,
    scene_from_numpy,
    tree_from_numpy,
)
from hare_tpu_torch.mesh import shapes  # noqa: E402
from hare_tpu_torch.utils import (  # noqa: E402
    HareConfig,
    MetricsLogger,
    determinism_check,
    enable_debug_checks,
    latest_step,
    restore_state,
    save_state,
    timed,
    trace_metrics,
    trace_profile,
)
from hare_tpu_torch.utils.checkpoint import MAX_TO_KEEP  # noqa: E402

# The port's entry points place tensors on "cuda" unless told otherwise;
# these tests run the plain versions on the CPU.
CPU = "cpu"

# Bounce energies: the same f32 products in the same order, summed over
# the rays in another order (tests/test_torch_trace.py's RTOL).
RTOL = 1e-5
ACCELS = ("brute", "grid", "octree", "kdtree", "kdtree_ropes")


def rays_np(n, seed=0, origin=(2.0, 2.5, 1.5)):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return np.tile(np.array([origin], np.float32), (n, 1)), d


def test_config_roundtrip_and_cli():
    c = HareConfig()
    assert HareConfig.from_json(c.to_json()) == c
    c3 = HareConfig.from_cli(["--accel", "kdtree", "--n-rays", "1024", "--avg-polys", "4.0",
                              "--max-depth", "9", "--win", "32"])
    assert c3.accel == "kdtree" and c3.n_rays == 1024 and c3.avg_polys == 4.0
    assert c3.max_depth == 9 and c3.win == 32
    assert c3.accel_params() == {"max_depth": 9, "max_tris_per_node": 16}
    assert HareConfig(accel="grid", domain=16).accel_params() == {"domain": 16}
    assert HareConfig(win=8).accel_params() == {"max_doublings": 6, "avg_polys": 10.0, "win": 8}
    assert HareConfig(accel="brute").accel_params() == {}
    # Every field but the TPU knobs, with the JAX defaults and CLI names.
    jd, td = json.loads(JHareConfig().to_json()), json.loads(c.to_json())
    assert set(jd) - set(td) == {"cap", "march", "soft", "tier", "cap_s"}
    assert all(jd[k] == v for k, v in td.items())
    jopts = {a.dest for a in JHareConfig.parser()._actions} - {"cap", "march", "soft", "tier",
                                                              "cap_s"}
    assert jopts == {a.dest for a in HareConfig.parser()._actions}


@pytest.mark.parametrize("knob, value", [("cap", 8), ("march", 16), ("soft", 4), ("tier", 2),
                                         ("cap_s", 64)])
def test_config_reads_jax_json(knob, value):
    """A JAX config's JSON loads (its knobs at their defaults are dropped);
    one whose knob holds another value raises, naming the knob."""
    jc = JHareConfig(accel="octree", n_rays=4096, seed=3)
    c = HareConfig.from_json(jc.to_json())
    assert c.accel == "octree" and c.n_rays == 4096 and c.seed == 3
    with pytest.raises(ValueError, match=knob):
        HareConfig.from_json(jc.replace(**{knob: value}).to_json())


def _struct_tensors(st):
    return {k: v for k, v in st._asdict().items() if isinstance(v, torch.Tensor)}


@pytest.mark.parametrize("accel", ACCELS)
def test_config_partition_matches_jax(accel):
    """SpatialPartition(top, accel=cfg.accel, kernel=cfg.kernel,
    **cfg.accel_params()) builds tables bit-equal to the JAX package's
    partition from the JAX config (through the port's converters)."""
    jc = JHareConfig(accel=accel, max_tris_per_node=8)
    c = HareConfig.from_json(jc.to_json())
    jt = jh.Topology.build(jshapes.concert_hall())
    tt = th.Topology.build(shapes.concert_hall())
    jsp = jh.SpatialPartition(jt, accel=jc.accel, kernel=jc.kernel, **jc.accel_params())
    sp = th.SpatialPartition(tt, accel=c.accel, kernel=c.kernel, device=CPU, **c.accel_params())
    want_scene = scene_from_numpy({k: np.asarray(v) for k, v in jsp.scene._asdict().items()},
                                  device=CPU)
    for f in sp.scene._fields:
        assert torch.equal(getattr(sp.scene, f), getattr(want_scene, f)), f
    if accel == "brute":
        assert sp.aux is None
        return
    a = jsp.aux
    if accel == "grid":
        want = grid_from_numpy({k: np.asarray(getattr(a, k)) for k in (
            "cell_meta", "win_data", "grid_min", "voxel_size")}, a.dims, a.char_step,
            a.max_cell_wins, a.n_tris, device=CPU)
    elif accel == "kdtree_ropes":
        want = ropes_from_numpy(a, device=CPU)
    else:
        want = tree_from_numpy(a, device=CPU)
    got, exp = _struct_tensors(sp.aux), _struct_tensors(want)
    assert got.keys() == exp.keys()
    for k in got:
        assert torch.equal(got[k], exp[k]), k
    assert sp.char_step == pytest.approx(jsp.char_step, rel=1e-6)


def test_metrics_logger(tmp_path):
    p = tmp_path / "m.jsonl"
    log = MetricsLogger(str(p))
    log.write(step=0, rays_per_s=1.5e6, note="hello", big=torch.arange(100.0))
    log.grad_norms({"absorption": torch.ones(4)}, step=1)
    lin = torch.nn.Linear(3, 2)
    lin(torch.ones(1, 3)).sum().backward()
    log.grad_norms(lin.named_parameters(), step=2)
    log.close()
    lines = [json.loads(l) for l in p.read_text().splitlines()]
    assert lines[0]["step"] == 0 and lines[0]["rays_per_s"] == 1.5e6
    assert lines[0]["big"] == {"mean": 49.5, "min": 0.0, "max": 99.0}
    assert abs(lines[1]["grad_norms"]["absorption"] - 2.0) < 1e-6
    assert lines[2]["grad_norms"] == pytest.approx({"weight": 6 ** 0.5, "bias": 2 ** 0.5})


def test_trace_metrics_matches_jax():
    """trace_metrics of one trace of the same rays in each package: the same
    five keys and values (the rounded per-bounce lists equal, the total
    within RTOL)."""
    o, d = rays_np(64)
    jt = jh.Topology.build(jshapes.shoebox())
    res_j = jh.trace_rays(jt.scene(), jh.Ray.make(o, d), jnp.full(jt.n_polys, 0.3), 3,
                          jh.accel.shoot_brute)
    tt = th.Topology.build(shapes.shoebox())
    res = th.trace_rays(tt.scene(device=CPU), th.Ray.make(torch.from_numpy(o),
                                                          torch.from_numpy(d)),
                        torch.full((tt.n_polys,), 0.3), 3, th.shoot_brute)
    m, mj = trace_metrics(res), j_trace_metrics(res_j)
    assert m.keys() == mj.keys()
    for k in ("bounce_occupancy", "n_rays", "n_bounces"):
        assert m[k] == mj[k], k
    np.testing.assert_allclose(m["bounce_energy"], mj["bounce_energy"], atol=1e-4)
    assert m["total_energy"] == pytest.approx(mj["total_energy"], rel=RTOL)
    assert m["total_energy"] == pytest.approx(sum(m["bounce_energy"]), rel=1e-4)


def test_checkpoint_roundtrip(tmp_path):
    d = str(tmp_path / "ckpt")
    p = torch.linspace(0, 1, 7, requires_grad=True)
    opt = torch.optim.Adam([p], lr=0.1)
    p.sum().backward()
    opt.step()
    gen = torch.Generator().manual_seed(3)
    state = {"params": {"absorption": p.detach()}, "opt_state": opt.state_dict(),
             "rng": gen.get_state(), "cursor": 42}
    assert latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        restore_state(d, state)
    save_state(d, 5, state)
    save_state(d, 9, {**state, "params": {"absorption": p.detach() + 1}, "cursor": 43})
    assert latest_step(d) == 9
    out5 = restore_state(d, state, step=5)
    assert torch.equal(out5["params"]["absorption"], p.detach())
    assert torch.equal(out5["rng"], gen.get_state())
    assert torch.equal(out5["opt_state"]["state"][0]["exp_avg"], opt.state[p]["exp_avg"])
    assert out5["opt_state"]["param_groups"] == opt.state_dict()["param_groups"]
    assert restore_state(d, state)["cursor"] == 43
    # Keys, shapes and dtypes are checked against the template.
    for bad in ({**state, "extra": 1}, {**state, "params": {"absorption": torch.zeros(8)}},
                {**state, "params": {"absorption": torch.zeros(7, dtype=torch.float64)}},
                {**state, "cursor": 1.0}):
        with pytest.raises(ValueError):
            restore_state(d, bad)
    for s in range(10, 10 + MAX_TO_KEEP + 2):
        save_state(d, s, state)
    assert sorted(int(f.stem.split("_")[1]) for f in (tmp_path / "ckpt").glob("step_*.pt")) == \
        list(range(12, 10 + MAX_TO_KEEP + 2))
    assert not list((tmp_path / "ckpt").glob("*.tmp"))


def test_determinism_check():
    tt = th.Topology.build(shapes.shoebox())
    sp = th.SpatialPartition(tt, domain=4, device=CPU)
    rng = np.random.default_rng(0)
    o = rng.uniform((1, 1, 1), (3, 4, 2), (64, 3)).astype(np.float32)
    dd = rng.normal(size=(64, 3)).astype(np.float32)
    rays = th.Ray.make(torch.from_numpy(o), torch.from_numpy(dd))
    assert determinism_check(lambda: sp.shoot(rays))
    assert determinism_check(lambda: {"x": [torch.tensor([np.nan, 1.0])], "n": 3})

    def flaky():
        return {"stable": torch.ones(2), "noise": (torch.zeros(2), torch.rand(3))}

    with pytest.raises(AssertionError, match=r"noise\[1\]"):
        determinism_check(flaky)


def test_timed_runs():
    dt, out = timed(lambda x: x * 2.0, torch.ones(128), iters=3)
    assert dt >= 0 and float(out[0]) == 2.0
    calls = []
    timed(lambda: calls.append(1), iters=4, warmup=2)
    assert len(calls) == 6


def test_trace_profile_writes_a_trace(tmp_path):
    with trace_profile(str(tmp_path / "prof")) as prof:
        torch.ones(64).cumsum(0)
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert len(prof.events()) > 0


def test_debug_checks_raise_by_stage():
    """enable_debug_checks: a NaN absorption raises FloatingPointError at
    trace_rays; NaN energies at energy_histogram; with ``infs`` an Inf
    target at make_train_step's loss, and with ``nans`` anomaly mode
    raises in the NaN target's backward.  Off, nothing raises."""
    from hare_tpu_torch import dist as hd

    tt = th.Topology.build(shapes.shoebox(4, 5, 3))
    sp = th.SpatialPartition(tt, domain=4, device=CPU)
    o, d = rays_np(16)
    rays = th.Ray.make(torch.from_numpy(o), torch.from_numpy(d))
    nan_a = torch.full((tt.n_polys,), float("nan"))
    res = th.trace_rays(sp.scene, rays, torch.full((tt.n_polys,), 0.3), 2, sp.shoot_fn,
                        aux=sp.aux)
    bad = res._replace(energy=torch.full_like(res.energy, float("nan")))
    th.trace_rays(sp.scene, rays, nan_a, 2, sp.shoot_fn, aux=sp.aux)  # off: no check
    enable_debug_checks()
    try:
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="trace_rays"):
            th.trace_rays(sp.scene, rays, nan_a, 2, sp.shoot_fn, aux=sp.aux)
        with pytest.raises(FloatingPointError, match="energy_histogram"):
            th.energy_histogram(bad, 16)
        import torch.distributed as tdist

        from hare_tpu_torch.examples._group import join_group, leave_group

        made = join_group(CPU)
        try:
            p = {"absorption": torch.zeros(tt.n_polys, requires_grad=True)}
            step = hd.make_train_step(sp.shoot_fn, torch.optim.Adam(p.values()), 2, 16)
            assert tdist.get_world_size() == 1
            with pytest.raises(RuntimeError, match="nan"):
                step(p, sp.scene, rays, torch.full((16,), float("nan")), sp.aux)
            enable_debug_checks(nans=False, infs=True)
            assert not torch.is_anomaly_enabled()
            with pytest.raises(FloatingPointError, match="make_train_step"):
                step(p, sp.scene, rays, torch.full((16,), float("inf")), sp.aux)
        finally:
            leave_group(made)
    finally:
        enable_debug_checks(nans=False)
    assert not torch.is_anomaly_enabled()
    th.energy_histogram(bad, 16)
    th.energy_histogram(res._replace(energy=torch.full_like(res.energy, float("inf"))), 16)


def test_fault_injection_resume(tmp_path):
    """tests/test_utils.py::test_fault_injection_resume on the port: a sweep
    killed at step 3 and restarted from its latest checkpoint (parameters,
    Adam's state_dict, the cursor) ends bit-equal to an uninterrupted one."""
    tt = th.Topology.build(shapes.shoebox(4, 5, 3))
    sp = th.SpatialPartition(tt, accel="grid", domain=4, device=CPU)
    o, d = rays_np(64)
    rays = th.Ray.make(torch.from_numpy(o), torch.from_numpy(d))

    def hist(a):
        res = th.trace_rays(sp.scene, rays, a, 3, sp.shoot_fn, aux=sp.aux)
        return th.energy_histogram(res, 64, 1e-3)

    with torch.no_grad():
        target = hist(torch.full((tt.n_polys,), 0.4))
    ckdir = str(tmp_path / "ck")

    def sweep(n_steps, fail_at=None):
        p = torch.zeros(tt.n_polys, requires_grad=True)
        opt = torch.optim.Adam([p], lr=0.1)
        start = 0
        if latest_step(ckdir) is not None:
            p.grad = torch.zeros_like(p)
            opt.step()  # every parameter's state present: the template's keys
            st = restore_state(ckdir, {"params": p.detach(), "opt_state": opt.state_dict(),
                                       "cursor": 0})
            with torch.no_grad():
                p.copy_(st["params"])
            opt.load_state_dict(st["opt_state"])
            start = st["cursor"]
        for i in range(start, n_steps):
            if fail_at is not None and i == fail_at:
                raise RuntimeError("injected host failure")
            opt.zero_grad()
            torch.sum((hist(torch.sigmoid(p)) - target) ** 2).backward()
            opt.step()
            save_state(ckdir, i, {"params": p.detach(), "opt_state": opt.state_dict(),
                                  "cursor": i + 1})
        return p.detach()

    ref = sweep(6)
    shutil.rmtree(ckdir)
    with pytest.raises(RuntimeError, match="injected"):
        sweep(6, fail_at=3)
    resumed = sweep(6)
    assert torch.equal(ref, resumed)
    assert not torch.equal(ref, torch.zeros_like(ref))
