"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py    # from the repository root, on a GPU host

The bench scene of ``bench.py`` (``shoebox(20,20,20)`` + ``icosphere(6)``,
81,932 triangles, voxel grid ``domain=48``) goes through
``Topology.build`` -> ``SpatialPartition`` -> ``trace_rays`` (3 bounces of
32,768 rays) -> ``energy_histogram(1024, 1e-3)`` -> ``backward()`` w.r.t.
per-polygon absorption, on the card.  Phases, one line each:

1. the card (``nvidia-smi`` name and power limit) and the kernel build time;
2. the host build of the scene and grid;
3. each CUDA kernel against its plain PyTorch version at the main path's
   shapes: time per call from CUDA events, the kernel's own device time
   from torch.profiler, and its bound (``hare_tpu_torch.benchmarks.
   bounds``: the least time the card could take for the same work).  K1
   runs on the rays of each of the 3 bounces of one trace, against its
   plain version (bit-equal) and against B1 (bit-equal on the first
   bounce; on the rays where the two differ later, the float64 oracle must
   side with K1 at least as often as with B1), with the cells and triangle slots its
   march visits (``voxel.grid_work``), its bound and its share of it, and
   the wrapper's host cost per call;
4. the main path end to end, with its launch counts and invariants;
5. forward and forward+backward step times, Mrays/s, and where one step's
   device time goes (idle share of the card);
6. the four Pallas probe kernels of ``benchmarks/`` (P1 ``column_sum``,
   P2-P4 ``gather_sum``) through the port's probes
   (``hare_tpu_torch.benchmarks``) at the JAX probes' shapes: each probe
   driven once with its launch count, each kernel against its plain
   version, time per call and on the device, ns per gathered row and GB/s.
7. the other backends: the host builds of the octree, KD tree and rope
   tree; B1 ``brute_shoot``, B2 ``tree_shoot`` and B3 ``ropes_shoot``
   against their plain versions, bit-equal, at each path's full width (B2
   and B3 on the rays of each of the 3 bounces of the bench scene, with
   device time, pops or steps and bound per bounce; B2 on config 3's hall;
   B1 on config 1, timed, and on the bench scene) and B1 against the
   float64 oracle; B2 and B3 against B1 on the bench scene's first bounce;
   the main path through ``octree``, ``kdtree`` and ``kdtree_ropes`` on the
   bench scene,
   ``octree`` on the reference's eval config 3 (concert hall, 1M rays,
   fwd+bwd) and ``brute`` on eval config 1 (shoebox, 10k rays, fwd), each
   counted, checked and held against the plain versions on the CPU for a
   sub-batch; their shoot times, pops or steps per ray, step times,
   Mrays/s and idle shares; stack against ropes.
8. vertex gradients and the soft histogram: A3 ``finalize_hits_bwd`` on
   the rays of each bench bounce against its plain version (autograd
   through the triangle test), element by element; the fixed-order
   ``scatter_add_ordered`` on A3's corner cotangents of every bounce and
   on the absorption keys against its plain version on the CPU (to the
   bit) and one CPU ``index_add_``, timed beside ``index_add_`` on the card
   (its yardstick); K3's soft mode and its backward on a 3-bounce trace
   record, all repeatable to the bit; five bench fwd+bwd steps w.r.t.
   absorption and five w.r.t. the vertices (soft bins) bitwise identical;
   the bench scene's fwd+bwd w.r.t. the vertices (soft bins, first-moment
   loss), counted and held against the CPU; and eval config 4 at full
   size (655,372 triangles, SAH KD tree, 32,768 rays, 2 bounces, 512
   bins): A3 and the scatter on the rays of each of its bounces as above,
   then its hard-histogram loss, whose vertex gradient is zero, and the
   soft first-moment loss, whose is not, every kernel's launches counted.

Any failed check raises: there is no fallback.  The second-to-last line is
the per-kernel JSON record, the last ``{"ok": true, "device": ...}``.
"""

import json
import math
import subprocess
import sys
import time

import torch

N_RAYS, N_BOUNCES, N_BINS, BIN_DT, ABSORPTION = 1 << 15, 3, 1024, 1e-3, 0.3
# Each traversal kernel agrees with its plain version to the bit
# (same_bits).  Against B1, whose table rounds the edges otherwise, and for
# K2's u, v, point and normal: within RTOL / ATOL.
RTOL, ATOL = 1e-5, 1e-5
# Rays whose winning triangle differs between a traversal and B1 may only be
# equal-t ties (|dt| within RTOL), and at most this share of rays.
MAX_TIE_SHARE = 1e-3
# K3 sums in a fixed order of its own, index_add_ in index order: per-bin
# sums agree to f32 rounding, measured relative to the histogram total.
HIST_REL_TOL = 1e-5
# A3 against its plain version in float64: element by element, each ray
# within hare_tpu_torch.benchmarks.a3_check's A3_TOL of its bound (the size
# of what it sums times its condition number, plus the effect of rounding
# its inputs; that module's readings: planted faults fall far outside it);
# the f32 plain version is read beside.
# The scatter against one CPU index_add_ (each key's values in index order,
# uncut, where the kernel adds a long run's 1024-value pieces in order):
# the same values summed in another order, relative to the largest sum of
# |values| of a key.
SCATTER_REL_TOL = 1e-4
# The soft backward against autograd through the plain soft histogram:
# the same operations, relative to the largest gradient.
SOFT_BWD_REL_TOL = 1e-6
# The small-input reference: the plain versions on the CPU, which the CPU
# tests hold against the JAX package.  Summed energies and gradients over
# thousands of lanes, in another order.
REF_RAYS, REF_RTOL = 2048, 1e-4
# B1 against the float64 oracle: tests/test_brute.py's tolerance on t and
# the hit point.
ORACLE_ATOL = 1e-3


def cuda_time(fn, reps):
    """Mean milliseconds per call of ``fn()`` over ``reps`` calls, by CUDA
    events, after one warm-up call.  Where the host enqueues slower than the
    card runs, this is the host's time per call."""
    from hare_tpu_torch.benchmarks.pallas_probe import seconds_per_call

    return seconds_per_call(fn, "cuda", reps) * 1e3


def timed_once(fn):
    """``fn()``'s result and its milliseconds by CUDA events: one call, for
    a plain version too slow to repeat."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def launch_ms(fn, reps, tag):
    """Device ms of one call of ``fn()`` in the kernels whose name contains
    ``tag``, each launched once a call: for each such name, the mean over
    its launches the profiler recorded in ``reps`` calls (it now and then
    drops one, which leaves the mean of like launches unbiased), summed.
    Fails where the profiler recorded nothing (``bench_scene.
    profile_kernels``) or no launch of ``tag``."""
    from hare_tpu_torch.benchmarks.bench_scene import profile_kernels

    times = profile_kernels(fn, reps)
    means = [t / k for name, (t, k) in times.items() if tag in name]
    check(len(means) > 0, f"the profiler recorded no launch of {tag}")
    check(all(k <= reps for name, (_, k) in times.items() if tag in name),
          f"{tag} names a kernel launched more than once a call")
    return sum(means) / 1e3


def all_kernels_ms(fn, reps):
    """Device ms of all the kernels one call of ``fn()`` launches, over
    ``reps`` calls."""
    from hare_tpu_torch.benchmarks.bench_scene import profile_kernels

    return sum(t for t, _ in profile_kernels(fn, reps).values()) / reps / 1e3


def step_ms(fn, reps):
    """Device ms of one step ``fn()``: all the kernel time the profiler
    recorded in ``reps`` steps, over ``reps``; and the same for each kernel
    name."""
    from hare_tpu_torch.benchmarks.bench_scene import profile_kernels

    times = profile_kernels(fn, reps)
    return sum(t for t, _ in times.values()) / reps / 1e3, {
        name: t / reps / 1e3 for name, (t, _) in times.items()}


def kernel_ms(per_name_ms, tag):
    """Sum of the ms of the kernels whose name contains ``tag``."""
    return sum(ms for name, ms in per_name_ms.items() if tag in name)


def gather_phase(label, tab, idx, iters, out_dtype, call_ms):
    """Hold ``gather_sum`` against its plain version on one probe's inputs,
    time both, print one line; returns the probe's measurements."""
    from hare_tpu_torch.benchmarks import bounds
    from hare_tpu_torch.benchmarks import pallas_probe as pp

    k = pp.gather_sum(tab, idx, iters, out_dtype)
    p = pp.gather_sum_plain(tab, idx, iters, out_dtype)
    if tab.dtype == torch.int32:  # int32 sums that wrap, or small integers in f32
        check(torch.equal(k, p), f"{label}: gather_sum differs from its plain version")
    else:
        check(pp.sums_agree(k, p, pp.gather_sum_plain(tab.abs(), idx, iters)),
              f"{label}: gather_sum differs from its plain version beyond the f32 bound")
    err = float((k.double() - p.double()).abs().max())
    dev_ms = launch_ms(lambda: pp.gather_sum(tab, idx, iters, out_dtype), 10, "gather_rows")
    def plain():
        return pp.gather_sum_plain(tab, idx, iters, out_dtype)

    plain_ms = cuda_time(plain, 5)
    plain_dev_ms = all_kernels_ms(plain, 3)
    b = bounds.gather_sum_bound(tab, idx, iters, k.dtype)
    rows = idx.shape[0] * iters
    gbs = rows * tab.shape[1] * tab.element_size() / (dev_ms * 1e-3) / 1e9
    ns_dev = dev_ms * 1e6 / rows
    print(f"phase 6 {label} {tuple(tab.shape)} {str(tab.dtype)[6:]}, {idx.shape[0]} rows x "
          f"{iters}: max |diff| {err:.3e}; kernel {call_ms:.4f} ms per call ({dev_ms:.4f} ms "
          f"on the device: {ns_dev:.4f} ns per gathered row, {gbs:.1f} GB/s of rows), "
          f"plain {plain_ms:.4f} ms ({plain_dev_ms:.4f} ms on the device); bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}: {b['bytes'] / 1e6:.2f} MB of distinct rows, "
          f"indices and sums), {b['bound_ms'] / dev_ms:.1%} of it")
    return dict(ms=call_ms, device_ms=dev_ms, plain_ms=plain_ms, plain_device_ms=plain_dev_ms,
                max_abs_err=err, ns_per_row=ns_dev, gbs=gbs, bound_ms=b["bound_ms"],
                bound_by=b["bound_by"], library_ms=None)


def probe_phase(dev):
    """Phase 6: P1-P4 at the JAX probes' shapes; returns their four records."""
    from hare_tpu_torch.benchmarks import bounds
    from hare_tpu_torch.benchmarks import pallas_probe as pp
    from hare_tpu_torch.benchmarks import r4_dyngather_probe as r4

    def on_card(arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    # P1: the probe's sweep, counted; then each table against the plain sum.
    pp.column_sum.launches = 0
    for mb in pp.VMEM_SWEEP_MB:
        check(pp.probe_vmem(mb, dev) is True, f"probe_vmem({mb}) failed")
    p1_launches = pp.column_sum.launches
    check(p1_launches > 0, "probe_vmem launched no column_sum kernel")
    by_mb = {}
    for mb in pp.VMEM_SWEEP_MB:
        x = torch.from_numpy(pp.vmem_table(mb)).to(dev)
        check(torch.equal(pp.column_sum(x), pp.column_sum_plain(x)),
              f"P1 column_sum differs at {mb} MB (sums of ones are exact)")
        ms = cuda_time(lambda: pp.column_sum(x), 50)
        # Two launches a call: the bands' partial sums, then their fold.
        dev_ms = launch_ms(lambda: pp.column_sum(x), 10, "column_sum")
        plain_ms = cuda_time(lambda: pp.column_sum_plain(x), 50)
        plain_dev_ms = all_kernels_ms(lambda: pp.column_sum_plain(x), 10)
        # The one PyTorch call that computes P1's function: the yardstick.
        library_ms = cuda_time(lambda: torch.sum(x, 0), 50)
        library_dev_ms = all_kernels_ms(lambda: torch.sum(x, 0), 10)
        b = bounds.column_sum_bound(*x.shape)
        gbs = x.numel() * 4 / (dev_ms * 1e-3) / 1e9
        by_mb[mb] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         plain_device_ms=plain_dev_ms, gbs=gbs, library_ms=library_ms,
                         library_device_ms=library_dev_ms, bound_ms=b["bound_ms"],
                         bound_by=b["bound_by"])
        print(f"phase 6 P1 column_sum {mb} MB ({x.shape[0]} x 192 f32): kernel {ms:.4f} ms "
              f"per call ({dev_ms:.4f} ms on the device, {gbs:.1f} GB/s), plain "
              f"{plain_ms:.4f} ms ({plain_dev_ms:.4f} ms on the device), torch.sum(x, 0) "
              f"{library_ms:.4f} ms ({library_dev_ms:.4f} ms on the device); bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}), {b['bound_ms'] / dev_ms:.1%} of it")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(x.shape, generator=g, device=dev)
    k, p = pp.column_sum(x), pp.column_sum_plain(x)
    check(pp.sums_agree(k, p, pp.column_sum_plain(x.abs())),
          "P1 column_sum differs on a normal table beyond the f32 bound")
    p1_err = float((k - p).abs().max())
    print(f"phase 6 P1 launches {p1_launches}; normal {tuple(x.shape)} table: max |diff| "
          f"{p1_err:.3e}")
    big = by_mb[pp.VMEM_SWEEP_MB[-1]]
    records = [dict(name="column_sum", route="cuda",
                    source="hare_tpu_torch/kernels/csrc/gather_probe.cu",
                    replaces="benchmarks/pallas_probe.py:29", launches=p1_launches,
                    max_abs_err=p1_err, ms=big["ms"], plain_ms=big["plain_ms"],
                    bound_ms=big["bound_ms"], bound_by=big["bound_by"],
                    library_ms=big["library_ms"], device_ms=big["device_ms"],
                    plain_device_ms=big["plain_device_ms"],
                    library_device_ms=big["library_device_ms"],
                    gbs_by_mb={m: r["gbs"] for m, r in by_mb.items()})]

    # P2 and P3: each probe driven once, counted, then checked and timed.
    for name, probe, inputs, replaces in (
        ("gather_sum_f32", pp.probe_gather, pp.gather_inputs, "benchmarks/pallas_probe.py:58"),
        ("gather_sum_i32", pp.probe_meta_gather, pp.meta_gather_inputs,
         "benchmarks/pallas_probe.py:96"),
    ):
        pp.gather_sum.launches = 0
        call_ms, _ = probe(device=dev)
        launches = pp.gather_sum.launches
        check(launches > 0, f"{probe.__name__} launched no gather_sum kernel")
        tab, idx = on_card(inputs())
        r = gather_phase(f"{'P2' if name.endswith('f32') else 'P3'} {probe.__name__}",
                         tab, idx, 50, None, call_ms)
        records.append(dict(name=name, route="cuda",
                            source="hare_tpu_torch/kernels/csrc/gather_probe.cu",
                            replaces=replaces, launches=launches, **r))

    # P4: the r4 probe's three calls, counted together.
    pp.gather_sum.launches = 0
    call_ms = [r4.probe(*call, device=dev)[0] for call in r4.CALLS]
    launches = pp.gather_sum.launches
    check(launches > 0, "the r4 probe launched no gather_sum kernel")
    calls = []
    for (A, B, dtype, iters, label), ms in zip(r4.CALLS, call_ms):
        tab, idx = on_card(r4.probe_inputs(A, B, dtype))
        calls.append(dict(label=label, **gather_phase(
            "P4 r4 probe", tab, idx.reshape(-1), iters, torch.float32, ms)))
    records.append(dict(
        name="gather_sum_r4", route="cuda", source="hare_tpu_torch/kernels/csrc/gather_probe.cu",
        replaces="benchmarks/r4_dyngather_probe.py:57", launches=launches,
        max_abs_err=max(c["max_abs_err"] for c in calls),
        **{k: sum(c[k] for c in calls)
           for k in ("ms", "device_ms", "plain_ms", "plain_device_ms", "bound_ms")},
        bound_by=max(calls, key=lambda c: c["bound_ms"])["bound_by"], library_ms=None,
        calls=calls))
    return records


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def same_floats(a, b):
    """Two float tensors equal to the bit."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def rel_err(a, b):
    """max |a - b| over max |b|."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def host_time(fn, reps=10):
    """Mean wall milliseconds per call of ``fn()`` after one warm-up call,
    the card synchronised before and after."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3


def same_bits(label, k, p):
    """A kernel and its plain version on the same rays agree on every ray:
    best_t to the bit, best_tri, and the pops or steps where given (the
    kernels round as their plain versions do: ``-fmad=false``)."""
    for what, a, b in zip(("best_t", "best_tri", "pops or steps"), k, p):
        a, b = (x.view(torch.int32) if x.dtype == torch.float32 else x for x in (a, b))
        differ = int((a != b).sum())
        check(differ == 0, f"{label}: {what} differs from the plain version on {differ} rays")


def nearest_agree(label, k, p):
    """Two nearest-hit answers ``(best_t, best_tri)`` on the same rays: the
    same hit mask, ``|dt| <= ATOL + RTOL t``, and tri ids equal except at
    equal-t ties, at most ``MAX_TIE_SHARE`` of the rays.  Returns (max |dt|,
    tie flips)."""
    (tk, ik), (tp, ip) = k[:2], p[:2]
    hit = torch.isfinite(tp)
    check(torch.equal(torch.isfinite(tk), hit), f"{label}: the hit masks differ")
    dt = (tk - tp).abs()[hit]
    err = float(dt.max()) if bool(hit.any()) else 0.0
    check(bool((dt <= ATOL + RTOL * tp[hit].abs()).all()), f"{label}: t differs by {err}")
    flips = int(((ik != ip) & hit).sum())
    check(flips <= MAX_TIE_SHARE * tp.numel(), f"{label}: {flips} tri_id mismatches")
    return err, flips


def referee_agree(label, k, b1):
    """K1 against B1, whose triangle table rounds the edges otherwise: the
    same hit mask, and at most ``MAX_TIE_SHARE`` of the rays with another
    triangle or a t beyond ``ATOL + RTOL t``.  Returns (max |dt|, tri_id
    flips, rays beyond the t tolerance, the indices of the rays that
    differ)."""
    (tk, ik), (tb, ib) = k[:2], b1[:2]
    hit = torch.isfinite(tb)
    check(torch.equal(torch.isfinite(tk), hit), f"{label}: the hit masks differ")
    dt = torch.where(hit, (tk - tb).abs(), 0.0)
    flips = (ik != ib) & hit
    off = dt > ATOL + RTOL * torch.where(hit, tb.abs(), 0.0)
    differ = torch.nonzero(flips | off).squeeze(1)
    check(differ.numel() <= MAX_TIE_SHARE * tb.numel(), f"{label}: {differ.numel()} rays differ")
    return float(dt.max()), int(flips.sum()), int(off.sum()), differ.tolist()


def oracle_side(label, top, rays, k, b1, differ):
    """The float64 oracle on the rays where K1 and B1 differ: K1 must match
    it (a hit at t within ``ORACLE_ATOL``) on at least as many of them as B1
    does.  Returns {"rays", "k1_match", "b1_match", "k1_nearer",
    "b1_nearer", "detail": [(ray, t K1, t B1, t f64)]}."""
    from hare_tpu_torch.oracle import oracle_shoot

    o, d = (x.double().cpu().numpy() for x in (rays.origin, rays.direction))
    ex = rays.exclude_poly.cpu().numpy()
    tk, tb = k[0].cpu(), b1[0].cpu()
    out = dict(rays=len(differ), k1_match=0, b1_match=0, k1_nearer=0, b1_nearer=0, detail=[])
    for i in differ:
        ref = oracle_shoot(top, o[i], d[i], (int(ex[i, 0]), int(ex[i, 1])))
        t64 = float("inf") if ref is None else ref["t"]
        ek, eb = abs(float(tk[i]) - t64), abs(float(tb[i]) - t64)
        out["k1_match"] += int(ek <= ORACLE_ATOL)
        out["b1_match"] += int(eb <= ORACLE_ATOL)
        out["k1_nearer"] += int(ek < eb)
        out["b1_nearer"] += int(eb < ek)
        out["detail"].append((i, float(tk[i]), float(tb[i]), t64))
    check(out["k1_match"] >= out["b1_match"],
          f"{label}: the float64 oracle sides with B1 over K1 on {out['detail']}")
    return out


def drive(th, sp, rays, absorption, n_bins, counters, backward, closed):
    """One main path through the facade: trace_rays -> energy_histogram
    [-> backward()], with every counter in ``counters`` set to 0 just before
    and read just after.  Checks the launches, the histogram total against
    the summed bounce energies, every hit in a closed room, and the
    absorption gradient.  Returns (result, histogram, launches, gradient)."""
    for fn in counters:
        fn.launches = 0
    a = absorption.clone().requires_grad_(backward)
    with torch.set_grad_enabled(backward):
        res = th.trace_rays(sp.scene, rays, a, N_BOUNCES, sp.shoot_fn, aux=sp.aux)
        hist = th.energy_histogram(res, n_bins, BIN_DT)
        if backward:
            hist.sum().backward()
    torch.cuda.synchronize()
    launches = [fn.launches for fn in counters]
    check(all(n > 0 for n in launches), f"a kernel was not launched: {launches}")
    check(hist.shape == (n_bins,) and bool(torch.isfinite(hist).all()), "histogram not finite")
    check(bool(torch.isfinite(res.energy).all()) and bool(torch.isfinite(res.time).all()),
          "bounce energies or times not finite")
    if closed:
        check(bool(res.hit.all()), "a ray missed on some bounce of a closed room")
    e_sum, total = float(res.energy.detach().sum()), float(hist.detach().sum())
    check(math.isclose(total, e_sum, rel_tol=1e-5),
          f"histogram total {total} != summed bounce energies {e_sum}")
    g = a.grad
    if backward:
        check(bool(torch.isfinite(g).all()) and bool((g <= 0).all()) and float(g.sum()) < 0,
              "absorption gradient not finite and non-positive with a negative sum")
    return res, hist.detach(), launches, g


def cpu_reference(th, sp, rays, absorption, n_bins):
    """The first REF_RAYS rays through the same facade on the card and,
    with the scene and structure moved to the CPU, through the plain
    versions: the same per-bounce hits and polygons, energies, histogram and
    gradient within REF_RTOL."""
    cpu = torch.device("cpu")
    sub = th.Ray(*(x[:REF_RAYS] for x in rays))
    out = []
    for where in (rays.origin.device, cpu):
        scene = to_device(sp.scene, where)
        aux = None if sp.aux is None else to_device(sp.aux, where)
        a = absorption.to(where).clone().requires_grad_()
        r = th.trace_rays(scene, to_device(sub, where), a, N_BOUNCES, sp.shoot_fn, aux=aux)
        h = th.energy_histogram(r, n_bins, BIN_DT)
        h.sum().backward()
        out.append([x.detach().cpu() for x in (r.hit, r.poly_id, r.energy, h, a.grad)])
    k, c = out
    check(torch.equal(c[0], k[0]) and torch.equal(c[1], k[1]),
          "per-bounce hits or polygons differ from the CPU reference")
    for what, x, y in zip(("energy", "histogram", "gradient"), k[2:], c[2:]):
        check(torch.allclose(x, y, rtol=REF_RTOL, atol=REF_RTOL * float(y.abs().max())),
              f"{what} differs from the CPU reference")


def config_rays(th, origin, n, dev):
    """``benchmarks/configs.py``'s rays: n uniform directions (seed 0) from
    one source point."""
    d = th.uniform_sphere(n, torch.Generator().manual_seed(0), device=dev)
    return th.Ray.make(torch.tensor(origin, device=dev).expand(n, 3).contiguous(), d)


def backends_phase(dev, top, grid_sp, rays, batches, absorption, grid_hist):
    """Phase 7: the brute, octree, KD-tree and rope backends (B1-B3) on the
    bench scene (B2 and B3 on the rays ``batches`` of each bounce of the grid
    path's trace) and on the reference's eval configs 1 and 3.  Returns the
    three kernels' records."""
    import hare_tpu_torch as th
    from hare_tpu_torch.accel import brute, common, ropes, tree
    from hare_tpu_torch.benchmarks import bounds
    from hare_tpu_torch.mesh import shapes
    from hare_tpu_torch.oracle import oracle_shoot

    # ---- 7.1 host builds through the facade (the scene's own build apart).
    t0 = time.perf_counter()
    th.build_scene([top], device=dev)
    torch.cuda.synchronize()
    scene_s = time.perf_counter() - t0
    sps = {}
    for accel in ("octree", "kdtree", "kdtree_ropes"):
        t0 = time.perf_counter()
        sps[accel] = th.SpatialPartition(top, accel=accel, device=dev)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        st = sps[accel].struct
        print(f"phase 7 host build {accel}: {s - scene_s:.2f} s ({s:.2f} s with the scene): "
              f"{st.n_nodes} nodes, {st.win_geom.shape[0]} window rows, max_depth "
              f"{st.max_depth}")
    octree, kdtree, kdropes = (sps[a].struct for a in ("octree", "kdtree", "kdtree_ropes"))
    scene = grid_sp.scene

    # ---- 7.2 each kernel against its plain version, on the card: B2 and B3
    # on the rays of each bounce, with their bound counted from the plain
    # walk's work (the leaves' runs it tests, the node rows it reads).
    walks = (  # (label, kernel, plain version, structure, device kernel name, K or None)
        ("B2 tree_shoot octree", tree.tree_shoot, tree.tree_shoot_plain, octree,
         "tree_shoot_kernel", octree.branch),
        ("B2 tree_shoot kdtree", tree.tree_shoot, tree.tree_shoot_plain, kdtree,
         "tree_shoot_kernel", kdtree.branch),
        ("B3 ropes_shoot", ropes.ropes_shoot, ropes.ropes_shoot_plain, kdropes,
         "ropes_shoot_kernel", None),
    )
    walk_out, walk_rec = {}, {}
    for label, fn, plain, st, tag, branch in walks:
        per_bounce = []
        for b, r in enumerate(batches, 1):
            n = r.origin.shape[0]
            k = fn(r, st, with_stats=True)
            with common.tally_runs() as runs, common.tally_rows() as rows:
                p, plain_ms = timed_once(lambda: plain(r, st, with_stats=True))
            same_bits(f"{label} bounce {b}", k, p)
            bnd = bounds.walk_bound(n, runs, rows, st.win_ids, branch)
            if b == 1:
                walk_out[label] = k
            ms = cuda_time(lambda: fn(r, st), 10)
            dev_ms = launch_ms(lambda: fn(r, st), 10, tag)
            visits = k[2].double()
            per_bounce.append(dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, max_abs_err=0.0,
                                   bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"],
                                   visits_per_ray=float(visits.mean()),
                                   slots_per_ray=bnd["slots"] / n, slots_touched=bnd["slots_touched"],
                                   node_visits=bnd["node_visits"], node_bytes=bnd["node_bytes"]))
            print(f"phase 7 {label} bounce {b}: bit-equal to its plain version, "
                  f"{'steps' if branch is None else 'pops'} included; kernel {ms:.4f} ms per call "
                  f"({dev_ms:.4f} ms on the device), plain {plain_ms:.3f} ms; "
                  f"{'steps' if branch is None else 'pops'} per ray mean {float(visits.mean()):.2f}, "
                  f"max {int(visits.max())}; plain walk's work {bnd['slots']} triangle slots "
                  f"({bnd['slots'] / n:.1f} a ray) of {bnd['slots_touched']} distinct, "
                  f"{bnd['node_visits']} {'leaf steps' if branch is None else 'node rows read'} "
                  f"({bnd['node_bytes'] / 1e6:.3f} MB of distinct node rows): bound "
                  f"{bnd['bound_ms']:.5f} ms ({bnd['bound_by']}: {bnd['ops'] / 1e9:.4f} GFLOP, "
                  f"{bnd['bytes'] / 1e6:.3f} MB), {bnd['bound_ms'] / dev_ms:.2%} of it")
        mean = {key: sum(x[key] for x in per_bounce) / len(per_bounce)
                for key in ("ms", "device_ms", "plain_ms", "bound_ms")}
        walk_rec[label] = dict(max_abs_err=0.0, **mean, library_ms=None,
                               bound_by=max(per_bounce, key=lambda x: x["bound_ms"])["bound_by"],
                               bounces=per_bounce)
        print(f"phase 7 {label} mean of {len(batches)} bounces: {mean['ms']:.4f} ms per call "
              f"({mean['device_ms']:.4f} ms on the device), bound {mean['bound_ms']:.5f} ms, "
              f"{mean['bound_ms'] / mean['device_ms']:.2%} of it")

    # B1 on config 1 at full size (the bench scene's full width is in 7.3).
    room = th.Topology.build(shapes.shoebox(4, 5, 3))
    room_sc = room.scene(device=dev)
    c1_rays = config_rays(th, (2.0, 2.5, 1.5), 10_000, dev)
    same_bits("B1 config 1", brute.brute_shoot(room_sc, c1_rays),
              brute.brute_shoot_plain(room_sc, c1_rays))
    c1_ms = cuda_time(lambda: brute.brute_shoot(room_sc, c1_rays), 50)
    c1_dev_ms = launch_ms(lambda: brute.brute_shoot(room_sc, c1_rays), 20, "brute_shoot_kernel")
    c1_plain_ms = cuda_time(lambda: brute.brute_shoot_plain(room_sc, c1_rays), 20)
    c1_bound = bounds.brute_shoot_bound(c1_rays.origin.shape[0], room.n_tris)
    print(f"phase 7 B1 brute_shoot config 1 ({c1_rays.origin.shape[0]} rays x {room.n_tris} tris, "
          f"{room_sc.tri_geom.shape[0]} triangle rows with padding): bit-equal to its plain "
          f"version; kernel {c1_ms:.4f} ms per call ({c1_dev_ms:.4f} ms on the device), plain "
          f"{c1_plain_ms:.4f} ms; bound {c1_bound['bound_ms']:.6f} ms ({c1_bound['bound_by']}), "
          f"{c1_bound['bound_ms'] / c1_dev_ms:.2%} of it")
    # B1 against the float64 oracle on 1,000 config-1 rays (tests/test_brute.py).
    o_np, d_np = (x[:1000].double().cpu().numpy() for x in (c1_rays.origin, c1_rays.direction))
    refs = [oracle_shoot(room, o_np[i], d_np[i]) for i in range(1000)]
    sub1 = th.Ray(*(x[:1000] for x in c1_rays))
    for kernel in ("mt", "watertight"):
        hr = brute.shoot_brute(room_sc, sub1, kernel)
        hit, t, pt, poly = (x.cpu().numpy() for x in (hr.hit, hr.t, hr.point, hr.poly_id))
        for i, ref in enumerate(refs):
            check((ref is not None) == bool(hit[i]), f"B1 {kernel}: ray {i} hit differs from the oracle")
            if ref is not None:
                check(abs(float(t[i]) - ref["t"]) < ORACLE_ATOL and
                      float(abs(pt[i] - ref["point"]).max()) < ORACLE_ATOL and
                      int(poly[i]) == ref["poly_id"], f"B1 {kernel}: ray {i} differs from the oracle")
    print(f"phase 7 B1 brute_shoot against the float64 oracle: 1000 config-1 rays, mt and "
          f"watertight, t and point within {ORACLE_ATOL}, same polygons")

    # ---- 7.3 every traversal against B1, the referee, on the bench scene.
    b1 = brute.brute_shoot(scene, rays)
    b1_ms = cuda_time(lambda: brute.brute_shoot(scene, rays), 3)
    b1_dev_ms = launch_ms(lambda: brute.brute_shoot(scene, rays), 2, "brute_shoot_kernel")
    b1_plain, b1_plain_ms = timed_once(lambda: brute.brute_shoot_plain(scene, rays))
    same_bits("B1 bench scene", b1, b1_plain)
    b1_bound = bounds.brute_shoot_bound(N_RAYS, top.n_tris)
    print(f"phase 7 B1 brute_shoot bench scene ({N_RAYS} rays x {top.n_tris} tris = "
          f"{N_RAYS * top.n_tris / 1e9:.2f}e9 tests): bit-equal to its plain version; "
          f"{b1_ms:.3f} ms per call ({b1_dev_ms:.3f} ms on the device, "
          f"{N_RAYS * top.n_tris / b1_dev_ms / 1e6:.1f} G tests/s); plain {b1_plain_ms:.3f} ms; "
          f"bound {b1_bound['bound_ms']:.4f} ms ({b1_bound['bound_by']}), "
          f"{b1_bound['bound_ms'] / b1_dev_ms:.1%} of it")
    print("phase 7 against B1 on the first bounce: " + "; ".join(
        "{}: tie flips {}, max |dt| {:.3e}".format(label, *nearest_agree(f"{label} vs B1", k, b1)[::-1])
        for label, k in ((label, walk_out[label]) for label, *_ in walks)))

    # ---- 7.4 each backend's main path, counted, and 7.5 its times.
    rec_launch = {"brute": 0, "tree": 0, "ropes": 0}
    walk_fn = {"octree": tree.tree_shoot, "kdtree": tree.tree_shoot,
               "kdtree_ropes": ropes.ropes_shoot}
    walk_label = dict(zip(("octree", "kdtree", "kdtree_ropes"), (label for label, *_ in walks)))
    per_shoot = {}
    fb_mrays = {}
    for accel, sp in sps.items():
        counters = (walk_fn[accel], common.finalize_hits, th.energy_histogram)
        _, hist, launches, g = drive(th, sp, rays, absorption, N_BINS, counters, True, True)
        rec_launch["ropes" if accel == "kdtree_ropes" else "tree"] += launches[0]
        # An equal-t tie resolved another way sends that ray down another
        # path: its (at most N_BOUNCES) energies land in other bins.  With
        # uniform absorption the totals are equal; the bins may differ by
        # twice the energy of MAX_TIE_SHARE of the rays.
        l1 = float((hist - grid_hist).abs().sum())
        check(math.isclose(float(hist.sum()), float(grid_hist.sum()), rel_tol=1e-5) and
              l1 <= 2 * MAX_TIE_SHARE * float(grid_hist.sum()),
              f"{accel}: histogram differs from the grid path's by {l1}")
        cpu_reference(th, sp, rays, absorption, N_BINS)

        def fwd(sp=sp):
            with torch.no_grad():
                r = th.trace_rays(sp.scene, rays, absorption, N_BOUNCES, sp.shoot_fn, aux=sp.aux)
                th.energy_histogram(r, N_BINS, BIN_DT)

        def fwd_bwd(sp=sp):
            a = absorption.clone().requires_grad_()
            r = th.trace_rays(sp.scene, rays, a, N_BOUNCES, sp.shoot_fn, aux=sp.aux)
            th.energy_histogram(r, N_BINS, BIN_DT).sum().backward()

        fwd_ms, fb_ms = host_time(fwd, 5), host_time(fwd_bwd, 5)
        # The walk's device time a shoot, from 7.2 (like launches on each
        # bounce's rays, one profiled window a bounce).
        rec = walk_rec[walk_label[accel]]
        first, mean = rec["bounces"][0]["device_ms"], rec["device_ms"]
        busy, _ = step_ms(fwd_bwd, 3)
        per_shoot[accel] = (first, mean)
        fb_mrays[accel] = N_RAYS * N_BOUNCES / fb_ms / 1e3
        print(f"phase 7 {accel} main path: launches {launches}; all {N_RAYS} rays hit on "
              f"{N_BOUNCES} bounces; histogram within {l1:.3f} (L1) of the grid path's; "
              f"grad sum {float(g.sum()):.4f}; {REF_RAYS}-ray CPU reference agrees")
        print(f"phase 7 {accel} metric: shoot {first:.4f} ms on the device (bounce 1, 7.2), "
              f"{mean:.4f} ms (mean of {N_BOUNCES}); fwd {fwd_ms:.3f} ms, fwd+bwd {fb_ms:.3f} ms; "
              f"{fb_mrays[accel]:.4f} Mrays/s fwd+bwd; device busy {busy:.4f} ms a fwd+bwd step, "
              f"idle share {1 - busy / fb_ms:.3f}")

    print(f"phase 7 stack vs ropes (bench scene, same SAH KD tree): B2 stack {per_shoot['kdtree'][0]:.4f} "
          f"ms, B3 ropes {per_shoot['kdtree_ropes'][0]:.4f} ms per first-bounce shoot on the device "
          f"(ropes / stack {per_shoot['kdtree_ropes'][0] / per_shoot['kdtree'][0]:.2f}); mean of "
          f"{N_BOUNCES} bounces {per_shoot['kdtree'][1]:.4f} vs {per_shoot['kdtree_ropes'][1]:.4f} "
          f"ms; fwd+bwd {fb_mrays['kdtree']:.4f} vs {fb_mrays['kdtree_ropes']:.4f} Mrays/s")

    # Config 3: concert hall, octree, 1M rays, fwd+bwd w.r.t. absorption.
    hall = th.Topology.build(shapes.concert_hall())
    sp3 = th.SpatialPartition(hall, accel="octree", device=dev)
    r3 = config_rays(th, (15.0, 24.0, 8.0), 1_000_000, dev)
    a3 = torch.full((hall.n_polys,), ABSORPTION, device=dev)
    # B2 against its plain version on the path's own first-bounce rays: the
    # hall's coplanar stage, balcony and wall faces are where ties happen.
    k3 = tree.tree_shoot(r3, sp3.struct, with_stats=True)
    p3, p3_ms = timed_once(lambda: tree.tree_shoot_plain(r3, sp3.struct, with_stats=True))
    same_bits("B2 tree_shoot config 3", k3, p3)
    print(f"phase 7 B2 tree_shoot config 3 (concert hall octree, max_depth "
          f"{sp3.struct.max_depth}, stack bound {sp3.struct.stack}, 1M rays): bit-equal to its "
          f"plain version, pops included; plain {p3_ms:.3f} ms")
    counters = (tree.tree_shoot, common.finalize_hits, th.energy_histogram)
    res3, _, launches, g3 = drive(th, sp3, r3, a3, N_BINS, counters, True, False)
    rec_launch["tree"] += launches[0]
    cpu_reference(th, sp3, r3, a3, N_BINS)

    def fwd_bwd3():
        a = a3.clone().requires_grad_()
        r = th.trace_rays(sp3.scene, r3, a, N_BOUNCES, sp3.shoot_fn, aux=sp3.aux)
        th.energy_histogram(r, N_BINS, BIN_DT).sum().backward()

    fb3 = host_time(fwd_bwd3, 3)
    # The absorption gradient's fixed-order scatter on the hall's long runs
    # (a polygon hit by many of the 1M rays is one serial chain of adds).
    busy3, per_name3 = step_ms(fwd_bwd3, 2)
    runs3 = torch.unique(torch.clamp(res3.poly_id[0], min=0), return_counts=True)[1]
    print(f"phase 7 config 3 (concert hall {hall.n_tris} tris, octree, 1M rays, "
          f"{N_BOUNCES} bounces, fwd+bwd): launches {launches}; hit share "
          f"{float(res3.hit.float().mean()):.4f}; grad sum {float(g3.sum()):.4f}; "
          f"{REF_RAYS}-ray CPU reference agrees; {fb3:.3f} ms, "
          f"{1e6 * N_BOUNCES / fb3 / 1e3:.4f} Mrays/s fwd+bwd; device busy {busy3:.4f} ms a "
          f"step, of which the absorption gradient's scatter_add_ordered "
          f"{kernel_ms(per_name3, 'scatter_ordered'):.4f} ms (3 calls; bounce 1's longest run "
          f"{int(runs3.max())} of {runs3.numel()} polygons) and B2 "
          f"{kernel_ms(per_name3, 'tree_shoot_kernel'):.4f} ms")

    # Config 1: shoebox, brute, 10k rays, 256 bins, forward.
    sp1 = th.SpatialPartition(room, accel="brute", device=dev)
    a1 = torch.full((room.n_polys,), ABSORPTION, device=dev)
    counters = (brute.brute_shoot, common.finalize_hits, th.energy_histogram)
    _, _, launches, _ = drive(th, sp1, c1_rays, a1, 256, counters, False, True)
    rec_launch["brute"] += launches[0]
    cpu_reference(th, sp1, c1_rays, a1, 256)

    def fwd1():
        with torch.no_grad():
            r = th.trace_rays(sp1.scene, c1_rays, a1, N_BOUNCES, sp1.shoot_fn)
            th.energy_histogram(r, 256, BIN_DT)

    f1 = host_time(fwd1, 10)
    print(f"phase 7 config 1 (shoebox 12 tris, brute, 10k rays, {N_BOUNCES} bounces, fwd): "
          f"launches {launches}; all rays hit; {f1:.3f} ms, "
          f"{1e4 * N_BOUNCES / f1 / 1e3:.4f} Mrays/s fwd; {REF_RAYS}-ray CPU reference agrees")

    src = "hare_tpu_torch/kernels/csrc/"
    oct_r, kd_r, rp_r = (walk_rec[label] for label, *_ in walks)
    return [
        dict(name="brute_shoot", route="cuda", source=src + "brute_shoot.cu",
             replaces="hare_tpu/accel/brute.py:63", launches=rec_launch["brute"],
             max_abs_err=0.0, ms=c1_ms, plain_ms=c1_plain_ms, bound_ms=c1_bound["bound_ms"],
             bound_by=c1_bound["bound_by"], library_ms=None, device_ms=c1_dev_ms,
             bench_referee=dict(ms=b1_ms, device_ms=b1_dev_ms, plain_ms=b1_plain_ms,
                                bound_ms=b1_bound["bound_ms"], bound_by=b1_bound["bound_by"])),
        dict(name="tree_shoot", route="cuda", source=src + "tree_shoot.cu",
             replaces="hare_tpu/accel/tree.py:249", launches=rec_launch["tree"],
             max_abs_err=max(oct_r["max_abs_err"], kd_r["max_abs_err"]),
             **{k: oct_r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                      "device_ms")},
             kdtree=kd_r),
        dict(name="ropes_shoot", route="cuda", source=src + "ropes_shoot.cu",
             replaces="hare_tpu/accel/ropes.py:272", launches=rec_launch["ropes"], **rp_r),
    ]


def vertex_reference(th, sp, rays, absorption, n_bounces, n_bins, step_fn):
    """The first REF_RAYS rays through ``step_fn`` (``repeat_check.
    vertex_step``) on the card and, with the scene and structure moved to
    the CPU, through the plain versions: the histogram and the vertex
    gradient within REF_RTOL of the largest."""
    from types import SimpleNamespace

    cpu = torch.device("cpu")
    sub = th.Ray(*(x[:REF_RAYS] for x in rays))
    out = []
    for where in (rays.origin.device, cpu):
        part = SimpleNamespace(scene=to_device(sp.scene, where), shoot_fn=sp.shoot_fn,
                               aux=None if sp.aux is None else to_device(sp.aux, where))
        step = step_fn(th, part, to_device(sub, where), absorption.to(where), n_bounces, n_bins)
        out.append([x.detach().cpu() for x in step()])
    for what, k, c in zip(("histogram", "vertex gradient"), *out):
        check(torch.allclose(k, c, rtol=REF_RTOL, atol=REF_RTOL * float(c.abs().max())),
              f"{what} differs from the CPU reference by {rel_err(k, c):.3e} of its largest")


def a3_phase(label, scene, rays, best_tri, hr, seed, dev):
    """A3 on one shoot's rays with seeded cotangents against its plain
    version in float64 on the card: vertex ids equal, every element of
    d(origin), d(direction), the corner cotangents and the vertex sums
    within a3_check's tolerance, two launches bitwise equal; the same
    readings against the f32 plain version, and both f32 sides' largest
    |diff| from float64 over the largest |g|.  Returns the arguments, the
    kernel's outputs, the agreement and those float64 readings."""
    from hare_tpu_torch.accel import common, scatter
    from hare_tpu_torch.benchmarks import a3_check

    n, n_v = rays.origin.shape[0], scene.vertices.shape[0]
    args = (scene.vertices, scene.tri_meta, best_tri, hr.t, hr.hit, rays.origin, rays.direction,
            a3_check.seeded_cotangents(n, seed, dev))
    k = common.finalize_hits_bwd(*args)
    p = common.finalize_hits_bwd_plain(*args)
    p64 = common.finalize_hits_bwd_plain(
        *(x.double() if x.is_floating_point() else x for x in args[:-1]),
        tuple(g.double() for g in args[-1]))
    check(torch.equal(k[2], p[2].to(torch.int32)), f"A3 {label}: vertex ids differ")
    check(all(same_floats(x, y) for x, y in zip(k, common.finalize_hits_bwd(*args))
              if x.dtype == torch.float32), f"A3 {label}: two launches differ")
    bounds = a3_check.ray_bounds(args)
    agree = a3_check.agreement(k, p64, args, bounds)
    check(all(r["outside"] == 0 for r in agree.values()),
          f"A3 {label} differs from its plain version in float64: {agree}")
    agree32 = a3_check.agreement(k, p, args, bounds)
    dv = {"kernel": scatter.scatter_add_ordered(k[2], k[3], n_v),
          "plain": scatter.scatter_add_ordered(p[2].to(torch.int32), p[3], n_v)}
    dv_64 = scatter.scatter_add_plain(p64[2], p64[3], n_v)
    f64 = {key: (rel_err(x.double(), y), rel_err(z.double(), y)) for key, x, z, y in (
        ("d_origin", k[0], p[0], p64[0]), ("d_direction", k[1], p[1], p64[1]),
        ("d_vertices", dv["kernel"], dv["plain"], dv_64))}
    err = max(float((x.double() - y).abs().max()) for x, y in (
        (k[0], p64[0]), (k[1], p64[1]), (dv["kernel"], dv_64)))
    print(f"phase 8 A3 finalize_hits_bwd {label} ({n} rays, {int(hr.hit.sum())} hits): each ray "
          f"within {a3_check.A3_TOL} of its bound (a3_check.ray_bounds), the tolerance each "
          f"needs against the plain version in float64 / in float32: " + ", ".join(
              f"{key} {r['needed']:.3e} / {agree32[key]['needed']:.3e} ({r['outside']} outside; "
              f"median |g| {r['median_over_max']:.3e} of the largest)"
              for key, r in agree.items())
          + "; largest |diff| from float64 over the largest |g|, kernel / plain f32: "
          + ", ".join(f"{key} {x:.3e} / {y:.3e}" for key, (x, y) in f64.items())
          + "; vertex ids equal, two launches bitwise equal")
    return args, k, {"outputs": agree, "vs_f32_plain": agree32, "max_abs_err": err}, f64


def scatter_exact(label, kk, vv, n_keys):
    """The scatter on ``kk``, ``vv``: equal to its plain version on the CPU
    to the bit, within SCATTER_REL_TOL of one CPU index_add_ (each key in
    index order, uncut), two calls bitwise equal.  Returns the sums, that
    reading and the run lengths."""
    from hare_tpu_torch.accel import scatter

    out = scatter.scatter_add_ordered(kk, vv, n_keys)
    cpu = scatter.scatter_add_plain(kk.cpu(), vv.cpu(), n_keys)
    check(same_floats(out.cpu(), cpu), f"scatter ({label}) differs from its plain version")
    whole = torch.zeros_like(cpu).index_add_(0, kk.cpu().long(), vv.cpu())
    mass = torch.zeros_like(cpu).index_add_(0, kk.cpu().long(), vv.cpu().abs())
    vs_whole = float((out.cpu() - whole).abs().max()) / float(mass.max())
    check(vs_whole <= SCATTER_REL_TOL, f"scatter ({label}) differs from CPU index_add_ by "
          f"{vs_whole:.3e} of the largest sum of |values|")
    check(same_floats(out, scatter.scatter_add_ordered(kk, vv, n_keys)),
          f"scatter ({label}): two calls differ")
    runs = torch.unique(kk, return_counts=True)[1]
    cols = 1 if vv.dim() == 1 else vv.shape[1]
    print(f"phase 8 scatter_add_ordered, {label} ({kk.numel()} values x {cols} into {n_keys} keys, "
          f"{runs.numel()} used, longest run {int(runs.max())}, median {int(runs.median())}): "
          f"equal to its plain version on the CPU to the bit, to one CPU index_add_ within "
          f"{vs_whole:.3e} of the largest sum of |values|, two calls bitwise equal")
    return out, vs_whole, runs


def gradients_phase(dev, sp, rays, batches, absorption):
    """Phase 8: vertex gradients and the soft histogram on the bench scene
    (grid) and eval config 4.  Returns the records of A3, the scatter, K3's
    soft mode and the soft backward."""
    import hare_tpu_torch as th
    from hare_tpu_torch.accel import common, scatter, tree, voxel
    from hare_tpu_torch.benchmarks import bench_scene, bounds, configs, repeat_check
    from hare_tpu_torch.trace import bounce

    grid, scene = sp.struct, sp.scene
    n_v = scene.vertices.shape[0]
    src = "hare_tpu_torch/kernels/csrc/"

    # ---- 8.1 A3 on the rays of each bounce, seeded cotangents, against its
    # plain version on the card, element by element (per ray, and summed
    # onto the vertices).
    per_bounce, scratches = [], []
    for b, r in enumerate(batches, 1):
        n = r.origin.shape[0]
        best_t, best_tri = voxel.grid_shoot(r, grid)
        hr = common.finalize_hits(scene, r, best_t, best_tri)
        args, k, agree, f64 = a3_phase(f"bounce {b}", scene, r, best_tri, hr, b, dev)
        scratches.append((f"A3 bounce {b} corners", k[2], k[3], n_v))
        if b == 1:
            hr1 = hr
        ms = cuda_time(lambda: common.finalize_hits_bwd(*args), 20)
        dev_ms = launch_ms(lambda: common.finalize_hits_bwd(*args), 10, "finalize_bwd_kernel")
        plain_ms = cuda_time(lambda: common.finalize_hits_bwd_plain(*args), 5)
        bnd = bounds.finalize_hits_bwd_bound(best_tri, hr.hit, scene.tri_meta)
        per_bounce.append(dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                               max_abs_err=agree["max_abs_err"], agreement=agree["outputs"],
                               agreement_f32_plain=agree["vs_f32_plain"],
                               f64_rel_err=f64, bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"]))
        print(f"phase 8 A3 finalize_hits_bwd bounce {b} ({n} rays): kernel {ms:.4f} ms per call "
              f"({dev_ms:.4f} ms on the device), plain {plain_ms:.3f} ms; bound "
              f"{bnd['bound_ms']:.5f} ms ({bnd['bound_by']}: {bnd['bytes'] / 1e6:.2f} MB, "
              f"{bnd['ops'] / 1e6:.2f} Mop), {bnd['bound_ms'] / dev_ms:.1%} of it")
    a3 = {key: sum(x[key] for x in per_bounce) / len(per_bounce)
          for key in ("ms", "device_ms", "plain_ms", "bound_ms")}

    # ---- 8.2 the scatter on A3's scratch of every bounce and on the
    # absorption gradient's keys: against CPU index_add_, to the bit, and
    # repeatable; timed on bounce 1's corners and the absorption keys.
    pid = torch.clamp(hr1.poly_id, min=0)
    absorb_vals = torch.randn(pid.shape, generator=torch.Generator(device=dev).manual_seed(7),
                              device=dev)
    scat = {}
    for label, kk, vv, n_keys in scratches + [("absorption gradient", pid, absorb_vals,
                                               scene.n_polys)]:
        out, vs_whole, runs = scatter_exact(label, kk, vv, n_keys)
        if label not in ("A3 bounce 1 corners", "absorption gradient"):
            continue
        ms = cuda_time(lambda: scatter.scatter_add_ordered(kk, vv, n_keys), 50)
        dev_ms = launch_ms(lambda: scatter.scatter_add_ordered(kk, vv, n_keys), 10, "scatter_ordered")
        plain_ms = cuda_time(lambda: scatter.scatter_add_plain(kk, vv, n_keys), 50)
        lib_out, lib_idx = torch.zeros_like(out), kk.long()
        library_ms = cuda_time(lambda: lib_out.index_add_(0, lib_idx, vv), 50)
        library_dev_ms = all_kernels_ms(lambda: lib_out.index_add_(0, lib_idx, vv), 10)
        cols = 1 if vv.dim() == 1 else vv.shape[1]
        bnd = bounds.scatter_bound(kk, cols, n_keys)
        scat[label] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms,
                           library_device_ms=library_dev_ms, bound_ms=bnd["bound_ms"],
                           bound_by=bnd["bound_by"], max_abs_err=0.0, values=kk.numel(),
                           keys=n_keys, longest_run=int(runs.max()), vs_index_add=vs_whole)
        print(f"phase 8 scatter_add_ordered timed, {label}: {ms:.4f} ms per call with the sort "
              f"({dev_ms:.4f} ms the kernel on the device), plain {plain_ms:.4f} ms, index_add_ "
              f"on the card {library_ms:.4f} ms ({library_dev_ms:.4f} ms on the device); bound "
              f"{bnd['bound_ms']:.5f} ms ({bnd['bound_by']}), {bnd['bound_ms'] / dev_ms:.1%} of it")

    # ---- 8.3 K3's soft mode and its backward on a 3-bounce trace record;
    # the first-moment loss's gradient into the backward.
    with torch.no_grad():
        res = th.trace_rays(scene, rays, absorption, N_BOUNCES, sp.shoot_fn, aux=sp.aux)
    lanes = (res.energy, res.time, res.hit)
    weight = torch.arange(N_BINS, dtype=torch.float32, device=dev)

    def soft():
        return bounce.histogram_kernel(*lanes, N_BINS, BIN_DT, soft=True)

    def soft_bwd():
        return bounce.soft_histogram_bwd(*lanes, weight, N_BINS, BIN_DT)

    hs = soft()
    hs_p = bounce.soft_histogram_plain(*lanes, N_BINS, BIN_DT)
    total = float(hs_p.sum())
    soft_err = float((hs - hs_p).abs().max())
    check(soft_err <= HIST_REL_TOL * total, f"K3 soft differs by {soft_err} of total {total}")
    check(math.isclose(total, float(res.energy.sum()), rel_tol=1e-5), "K3 soft loses energy")
    check(same_floats(hs, soft()), "K3 soft: two launches differ")
    gk = soft_bwd()
    gp = bounce.soft_histogram_bwd_plain(*lanes, weight, N_BINS, BIN_DT)
    bwd_rel = max(rel_err(x, y) for x, y in zip(gk, gp))
    bwd_err = max(float((x - y).abs().max()) for x, y in zip(gk, gp))
    check(bwd_rel <= SOFT_BWD_REL_TOL, f"the soft backward differs by {bwd_rel:.3e}")
    check(all(same_floats(x, y) for x, y in zip(gk, soft_bwd())),
          "the soft backward: two launches differ")
    k3s = dict(ms=cuda_time(soft, 100), device_ms=launch_ms(soft, 10, "_partials"),
               plain_ms=cuda_time(lambda: bounce.soft_histogram_plain(*lanes, N_BINS, BIN_DT), 20),
               max_abs_err=soft_err, library_ms=None,
               **{k: bounds.histogram_bound(res.hit, N_BINS, soft=True)[k]
                  for k in ("bound_ms", "bound_by")})
    sb = dict(ms=cuda_time(soft_bwd, 100), device_ms=launch_ms(soft_bwd, 10, "soft_bwd_kernel"),
              plain_ms=cuda_time(
                  lambda: bounce.soft_histogram_bwd_plain(*lanes, weight, N_BINS, BIN_DT), 10),
              max_abs_err=bwd_err, library_ms=None,
              **{k: bounds.soft_histogram_bwd_bound(res.hit, N_BINS)[k]
                 for k in ("bound_ms", "bound_by")})
    for label, r, extra in (("K3 energy_histogram soft", k3s,
                             f"max |diff| / total {soft_err / total:.3e}"),
                            ("K3 soft_histogram_bwd", sb,
                             f"max |diff| {bwd_rel:.3e} of the largest")):
        print(f"phase 8 {label} ({res.hit.numel()} lanes, {N_BINS} bins): {extra}, two launches "
              f"bitwise equal; kernel {r['ms']:.4f} ms per call ({r['device_ms']:.4f} ms on the "
              f"device), plain {r['plain_ms']:.4f} ms; bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}), {r['bound_ms'] / r['device_ms']:.1%} of it")

    # ---- 8.4 the repair of bitwise repeats: five fwd+bwd steps each.
    diffs = {
        "absorption": repeat_check.max_diffs(
            repeat_check.absorption_step(th, sp, rays, absorption, N_BOUNCES), repeat_check.STEPS),
        "vertices, soft": repeat_check.max_diffs(
            repeat_check.vertex_step(th, sp, rays, absorption, N_BOUNCES), repeat_check.STEPS),
    }
    check(all(x == 0.0 for v in diffs.values() for x in v),
          f"a histogram or gradient differs between repeats: {diffs}")
    print(f"phase 8 repeats (bench scene, grid, {repeat_check.STEPS} fwd+bwd steps each, "
          f"loss sum(h * arange("
          f"{N_BINS}))): " + "; ".join(
        f"w.r.t. {key}: histogram max |diff| {h}, gradient max |diff| {g}"
        for key, (h, g) in diffs.items()))

    # ---- 8.5 the bench scene's fwd+bwd w.r.t. the vertices, soft bins.
    counters = (voxel.grid_shoot, common.finalize_hits, th.energy_histogram,
                common.finalize_hits_bwd, scatter.scatter_add_ordered, bounce.soft_histogram_bwd)
    names = ("grid_shoot", "finalize_hits", "energy_histogram", "finalize_hits_bwd",
             "scatter_add_ordered", "soft_histogram_bwd")
    vstep = repeat_check.vertex_step(th, sp, rays, absorption, N_BOUNCES)
    for fn in counters:
        fn.launches = 0
    hist, grad = vstep()
    torch.cuda.synchronize()
    launches = dict(zip(names, (fn.launches for fn in counters)))
    check(launches["finalize_hits_bwd"] == N_BOUNCES and launches["scatter_add_ordered"] >= N_BOUNCES
          and launches["energy_histogram"] == 1 and launches["soft_histogram_bwd"] == 1
          and launches["grid_shoot"] == N_BOUNCES, f"vertex path launches {launches}")
    check(bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0,
          "bench vertex gradient not finite and non-zero")
    check(math.isclose(float(hist.detach().sum()), float(N_RAYS * sum(0.7 ** k for k in (1, 2, 3))),
                       rel_tol=1e-4), "bench soft histogram total")
    vertex_reference(th, sp, rays, absorption, N_BOUNCES, N_BINS, repeat_check.vertex_step)
    fb_ms = host_time(vstep, 5)
    busy, per_name = step_ms(vstep, 3)
    print(f"phase 8 bench vertex path (grid, soft, loss sum(h * arange({N_BINS}))): launches "
          f"{launches}; gradient finite, max |g| {float(grad.abs().max()):.4e}; {REF_RAYS}-ray "
          f"CPU reference agrees; fwd+bwd {fb_ms:.3f} ms, {N_RAYS * N_BOUNCES / fb_ms / 1e3:.4f} "
          f"Mrays/s; device busy {busy:.4f} ms a step (A3 "
          f"{kernel_ms(per_name, 'finalize_bwd_kernel'):.4f}, scatter "
          f"{kernel_ms(per_name, 'scatter_ordered'):.4f}, K3 {kernel_ms(per_name, '_partials'):.4f}, "
          f"soft backward {kernel_ms(per_name, 'soft_bwd_kernel'):.4f} ms), idle share "
          f"{1 - busy / fb_ms:.3f}")

    # ---- 8.6 eval config 4 at full size.
    c4 = configs.config4_setup(dev)
    sp4, n4 = c4.partition, c4.rays.origin.shape[0]
    check(c4.topology.n_tris == 655_372, f"config 4 has {c4.topology.n_tris} triangles")
    st = sp4.struct
    table_mb = sum(x.numel() * x.element_size() for x in st if isinstance(x, torch.Tensor)) / 1e6
    print(f"phase 8 config 4 host build: topology {c4.topology_s:.2f} s, KD tree (SAH, "
          f"max_tris_per_node 8) {c4.kdtree_s:.2f} s: {c4.topology.n_tris} tris, {st.n_nodes} "
          f"nodes, max_depth {st.max_depth}, stack bound {st.stack}, {table_mb:.1f} MB of tables")

    # A3 and the scatter on the rays of each of config 4's bounces, as in
    # 8.1 and 8.2: its corner cotangents fall on some 10^5 vertex keys.
    n_v4 = sp4.scene.vertices.shape[0]
    for b, r in enumerate(bench_scene.bounce_rays(sp4, c4.rays, c4.absorption, c4.n_bounces),
                          1):
        best_t, best_tri = tree.tree_shoot(r, st)
        hr = common.finalize_hits(sp4.scene, r, best_t, best_tri)
        _, k, _, _ = a3_phase(f"config 4 bounce {b}", sp4.scene, r, best_tri, hr, 10 + b, dev)
        scatter_exact(f"config 4 A3 bounce {b} corners", k[2], k[3], n_v4)

    def hard_step():
        v = sp4.scene.vertices.clone().requires_grad_()
        r = th.trace_rays(sp4.scene.with_vertices(v), c4.rays, c4.absorption, c4.n_bounces,
                          sp4.shoot_fn, aux=sp4.aux)
        h = th.energy_histogram(r, c4.n_bins, BIN_DT)
        h.sum().backward()
        return h, v.grad

    soft_step = repeat_check.vertex_step(th, sp4, c4.rays, c4.absorption, c4.n_bounces, c4.n_bins)
    counters4 = counters + (tree.tree_shoot,)
    names4 = names + ("tree_shoot",)
    nb4 = c4.n_bounces
    # Launches a step.  The hard loss gives time no cotangent, yet autograd
    # runs A3 (on zero cotangents) and its scatter all the same.
    want = dict(grid_shoot=0, tree_shoot=nb4, finalize_hits=nb4, finalize_hits_bwd=nb4,
                energy_histogram=1)
    for label, fn, want_zero in (("(a) hard histogram sum", hard_step, True),
                                 ("(b) soft, first moment", soft_step, False)):
        for f in counters4:
            f.launches = 0
        h, g = fn()
        torch.cuda.synchronize()
        launches4 = dict(zip(names4, (f.launches for f in counters4)))
        g = torch.zeros_like(sp4.scene.vertices) if g is None else g
        check(bool(torch.isfinite(g).all()), f"config 4 {label}: gradient not finite")
        check(bool((g == 0).all()) if want_zero else float(g.abs().max()) > 0,
              f"config 4 {label}: gradient {'non-zero' if want_zero else 'zero'}")
        check(all(launches4[key] == n for key, n in want.items())
              and launches4["scatter_add_ordered"] >= nb4
              and launches4["soft_histogram_bwd"] == (0 if want_zero else 1),
              f"config 4 {label}: launches {launches4}")
        if not want_zero:
            vertex_reference(th, sp4, c4.rays, c4.absorption, c4.n_bounces, c4.n_bins,
                             repeat_check.vertex_step)
        fb_ms = host_time(fn, 3)
        busy, per_name = step_ms(fn, 2)
        parts = ", ".join(f"{part} {kernel_ms(per_name, tag):.4f}" for part, tag in (
            ("B2", "tree_shoot_kernel"), ("K2", "finalize_kernel"), ("A3", "finalize_bwd_kernel"),
            ("scatter", "scatter_ordered"), ("K3", "_partials"), ("soft backward", "soft_bwd")))
        print(f"phase 8 config 4 {label}: launches {launches4}; "
              f"hit share {float(h.detach().sum()) / (n4 * sum(0.7 ** k for k in (1, 2))):.4f} of the "
              f"closed-room energy; vertex gradient finite, max |g| {float(g.abs().max()):.4e}"
              f"{'' if want_zero else f'; {REF_RAYS}-ray CPU reference agrees'}; fwd+bwd "
              f"{fb_ms:.3f} ms, {n4 * c4.n_bounces / fb_ms / 1e3:.4f} Mrays/s fwd+bwd(vertices); "
              f"device busy {busy:.4f} ms ({parts} ms), idle share {1 - busy / fb_ms:.3f}")

    return [
        dict(name="finalize_hits_bwd", route="cuda", source=src + "finalize_bwd.cu",
             replaces="hare_tpu/accel/common.py:424", launches=launches["finalize_hits_bwd"],
             max_abs_err=max(x["max_abs_err"] for x in per_bounce), **a3,
             bound_by=max(per_bounce, key=lambda x: x["bound_ms"])["bound_by"], library_ms=None,
             bounces=per_bounce),
        dict(name="scatter_add_ordered", route="cuda", source=src + "scatter.cu",
             replaces="hare_tpu/accel/common.py:390", launches=launches["scatter_add_ordered"],
             **scat["A3 bounce 1 corners"], absorption=scat["absorption gradient"]),
        dict(name="energy_histogram", mode="soft", route="cuda", source=src + "energy_histogram.cu",
             replaces="hare_tpu/trace/bounce.py:280", launches=launches["energy_histogram"], **k3s),
        dict(name="soft_histogram_bwd", route="cuda", source=src + "energy_histogram.cu",
             replaces="hare_tpu/trace/bounce.py:289", launches=launches["soft_histogram_bwd"], **sb),
    ]


def to_device(nt, device):
    """A NamedTuple of tensors (Scene, VoxelGrid, Ray) on ``device``."""
    return type(nt)(*(x.to(device) if isinstance(x, torch.Tensor) else x for x in nt))


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")

    import hare_tpu_torch as th
    from hare_tpu_torch.accel import brute, common, voxel
    from hare_tpu_torch.benchmarks import bench_scene, bounds
    from hare_tpu_torch.kernels import build
    from hare_tpu_torch.trace import bounce

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)

    # ---- phase 1: the card and the kernel build.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    print(f"phase 1 device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}); "
          f"kernels built in {build_s:.2f} s")

    # ---- phase 2: the bench scene, host build.
    t0 = time.perf_counter()
    top, sp, rays, absorption = bench_scene.bench_setup(dev)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    check(top.n_tris == 81932, f"bench scene has {top.n_tris} triangles, not 81,932")
    grid = sp.struct
    print(f"phase 2 scene: {top.n_tris} tris, {top.n_polys} polys, grid {grid.dims}, "
          f"{grid.win_geom.shape[0]} window rows; host build {host_s:.2f} s")

    # ---- phase 3: each kernel against its plain version, main-path shapes.
    records = []
    # K1 on the rays of each bounce of one trace: against its plain version
    # and against B1, timed, and beside its bound from the plain march's work.
    per_bounce = []
    batches = bench_scene.bounce_rays(sp, rays, absorption)
    for b, r in enumerate(batches, 1):
        k, p = voxel.grid_shoot(r, grid), voxel.grid_shoot_plain(r, grid)
        plain_ms = cuda_time(lambda: voxel.grid_shoot_plain(r, grid), 1)
        same_bits(f"K1 bounce {b}", k, p)
        check(bool(torch.isfinite(k[0]).all()), f"K1: a bounce-{b} ray missed in the closed room")
        # B1 reads scene.tri_geom, whose edges are differences of f32
        # corners; K1's window rows hold f64 differences rounded once.  The
        # walls' corners are exact in both, so the first bounce agrees to
        # the bit; the sphere's edges differ in their last bits, which a
        # grazing ray turns into a larger dt, so on later bounces the
        # float64 oracle decides the rays where the two differ.
        b1 = brute.brute_shoot(sp.scene, r)
        b1_err, b1_flips, b1_off, differ = referee_agree(f"K1 vs B1 bounce {b}", k, b1)
        if b == 1:
            check(b1_err == 0.0 and b1_flips == 0, "K1 differs from B1 on the first bounce")
        side = oracle_side(f"K1 vs B1 bounce {b}", top, r, k, b1, differ)
        ms = cuda_time(lambda: voxel.grid_shoot(r, grid), 20)
        dev_ms = launch_ms(lambda: voxel.grid_shoot(r, grid), 10,
                           "grid_shoot_kernel")
        work = voxel.grid_work(r, grid)
        bnd = bounds.grid_shoot_bound(work)
        cells, slots = work.cells.double(), work.slots.double()
        per_bounce.append(dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, max_abs_err=0.0,
                               b1_max_abs_dt=b1_err, b1_flips=b1_flips,
                               b1_beyond_tol=b1_off, oracle=side,
                               bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"],
                               slots_per_ray=float(slots.mean()),
                               cells_per_ray=float(cells.mean())))
        print(f"phase 3 K1 grid_shoot bounce {b}: bit-equal to its plain version; against B1 "
              f"tri_id flips {b1_flips}, "
              f"max |dt| {b1_err:.3e}, rays beyond |dt| <= {ATOL} + {RTOL} t {b1_off}; on those "
              f"{side['rays']} rays the float64 oracle matches K1 on {side['k1_match']} and B1 on "
              f"{side['b1_match']} (t within {ORACLE_ATOL}), K1 nearer on {side['k1_nearer']}, "
              f"B1 on {side['b1_nearer']} {side['detail']}; kernel {ms:.4f} ms per call ({dev_ms:.4f} ms on the "
              f"device), plain {plain_ms:.3f} ms; a ray visits {float(cells.mean()):.2f} cells "
              f"(max {int(cells.max())}) and tests {float(slots.mean()):.1f} triangle slots "
              f"(max {int(slots.max())}); {work.cells_touched} cells and {work.slots_touched} "
              f"non-null window slots touched; bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}: "
              f"{bnd['ops'] / 1e9:.3f} GFLOP, {bnd['bytes'] / 1e6:.2f} MB), "
              f"{bnd['bound_ms'] / dev_ms:.1%} of it")
    k1 = {key: sum(x[key] for x in per_bounce) / len(per_bounce)
          for key in ("ms", "device_ms", "plain_ms", "bound_ms")}
    # The wrapper's host cost: a 1-ray batch, whose kernel is shorter than
    # its launch.
    one = th.Ray(*(x[:1] for x in rays))
    k1["host_us"] = host_time(lambda: voxel.grid_shoot(one, grid), 200) * 1e3
    print(f"phase 3 K1 grid_shoot mean of {len(per_bounce)} bounces: {k1['ms']:.4f} ms per call "
          f"({k1['device_ms']:.4f} ms on the device), bound {k1['bound_ms']:.4f} ms, "
          f"{k1['bound_ms'] / k1['device_ms']:.1%} of it; wrapper host cost "
          f"{k1['host_us']:.2f} us per call (1-ray batch)")
    records.append(dict(
        name="grid_shoot", route="cuda", source="hare_tpu_torch/kernels/csrc/grid_shoot.cu",
        replaces="hare_tpu/accel/voxel.py:414",
        max_abs_err=max(x["max_abs_err"] for x in per_bounce), **k1,
        bound_by=max(per_bounce, key=lambda x: x["bound_ms"])["bound_by"], library_ms=None,
        bounces=per_bounce))

    # K2 on K1's winners of the first bounce.
    bt_k, btri_k = voxel.grid_shoot(rays, grid)
    hk = common.finalize_hits(sp.scene, rays, bt_k, btri_k)
    hp = common.finalize_hits_plain(sp.scene, rays, bt_k, btri_k)
    for f in ("hit", "poly_id", "tri_id", "edge_nbr"):
        check(torch.equal(getattr(hk, f), getattr(hp, f)), f"K2 {f} differs")
    errs = {}
    for f in ("t", "u", "v", "point", "normal"):
        a, b = getattr(hk, f), getattr(hp, f)
        errs[f] = float((a - b).abs().max())
        check(torch.allclose(a, b, rtol=RTOL, atol=ATOL), f"K2 {f} differs by {errs[f]}")
    ms = cuda_time(lambda: common.finalize_hits(sp.scene, rays, bt_k, btri_k), 50)
    dev_ms = launch_ms(lambda: common.finalize_hits(sp.scene, rays, bt_k, btri_k), 10,
                       "finalize_kernel")
    plain_ms = cuda_time(lambda: common.finalize_hits_plain(sp.scene, rays, bt_k, btri_k), 20)
    bnd = bounds.finalize_hits_bound(btri_k)
    print("phase 3 K2 finalize_hits: max |diff| " +
          ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) +
          f"; kernel {ms:.4f} ms per call ({dev_ms:.4f} ms on the device), "
          f"plain {plain_ms:.4f} ms; bound {bnd['bound_ms']:.5f} ms ({bnd['bound_by']}: "
          f"{bnd['bytes'] / 1e6:.2f} MB), {bnd['bound_ms'] / dev_ms:.1%} of it")
    records.append(dict(name="finalize_hits", route="cuda",
                        source="hare_tpu_torch/kernels/csrc/finalize_hits.cu",
                        replaces="hare_tpu/accel/common.py:437",
                        max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
                        bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"], library_ms=None,
                        device_ms=dev_ms))

    # K3 on a real 3-bounce trace record.
    with torch.no_grad():
        res = th.trace_rays(sp.scene, rays, absorption, N_BOUNCES, sp.shoot_fn, aux=sp.aux)
    hist_k = bounce.histogram_kernel(res.energy, res.time, res.hit, N_BINS, BIN_DT)
    hist_p = bounce.histogram_plain(res.energy, res.time, res.hit, N_BINS, BIN_DT)
    total = float(hist_p.sum())
    k3_err = float((hist_k - hist_p).abs().max())
    check(k3_err <= HIST_REL_TOL * total, f"K3 differs by {k3_err} of total {total}")

    def k3():
        return bounce.histogram_kernel(res.energy, res.time, res.hit, N_BINS, BIN_DT)

    check(same_floats(hist_k, k3()), "K3: two launches differ")
    ms = cuda_time(k3, 100)
    dev_ms = launch_ms(k3, 10, "_partials")
    plain_ms = cuda_time(
        lambda: bounce.histogram_plain(res.energy, res.time, res.hit, N_BINS, BIN_DT), 100)
    bnd = bounds.histogram_bound(res.hit, N_BINS)
    print(f"phase 3 K3 energy_histogram: max |diff| / total {k3_err / total:.3e}, two "
          f"launches bitwise equal; "
          f"kernel {ms:.4f} ms per call ({dev_ms:.4f} ms on the device), "
          f"plain {plain_ms:.4f} ms; bound {bnd['bound_ms']:.5f} ms ({bnd['bound_by']}: "
          f"{bnd['bytes'] / 1e6:.2f} MB), {bnd['bound_ms'] / dev_ms:.1%} of it")
    records.append(dict(name="energy_histogram", mode="hard", route="cuda",
                        source="hare_tpu_torch/kernels/csrc/energy_histogram.cu",
                        replaces="hare_tpu/trace/bounce.py:294", max_abs_err=k3_err,
                        ms=ms, plain_ms=plain_ms, bound_ms=bnd["bound_ms"],
                        bound_by=bnd["bound_by"], library_ms=None, device_ms=dev_ms))

    # ---- phase 4: the main path end to end, counted.
    counters = (voxel.grid_shoot, common.finalize_hits, th.energy_histogram)

    def step(a):
        res = th.trace_rays(sp.scene, rays, a, N_BOUNCES, sp.shoot_fn, aux=sp.aux)
        hist = th.energy_histogram(res, N_BINS, BIN_DT)
        return res, hist

    for fn in counters:
        fn.launches = 0
    a = absorption.clone().requires_grad_()
    res, hist = step(a)
    loss = hist.sum()
    loss.backward()
    torch.cuda.synchronize()
    launches = [fn.launches for fn in counters]
    check(all(n > 0 for n in launches), f"a kernel was not launched: {launches}")
    check(bool(res.hit.all()), "a ray missed on some bounce of the closed room")
    check(hist.shape == (N_BINS,) and bool(torch.isfinite(hist).all()), "histogram not finite")
    e_sum = float(res.energy.detach().sum())
    total = float(loss.detach())
    check(math.isclose(total, e_sum, rel_tol=1e-5),
          f"histogram total {total} != summed bounce energies {e_sum}")
    g = a.grad
    check(bool(torch.isfinite(g).all()) and bool((g <= 0).all()) and float(g.sum()) < 0,
          "absorption gradient not finite and non-positive with a negative sum")

    # The small-input reference: the first REF_RAYS rays on the CPU.
    cpu = torch.device("cpu")
    scene_c, grid_c = to_device(sp.scene, cpu), to_device(grid, cpu)
    sub = th.Ray(*(x[:REF_RAYS] for x in rays))
    out = {}
    for where, scene_, grid_ in ((dev, sp.scene, grid), (cpu, scene_c, grid_c)):
        a_ = absorption.to(where).clone().requires_grad_()
        r_ = th.trace_rays(scene_, to_device(sub, where), a_, N_BOUNCES,
                           sp.shoot_fn, aux=grid_)
        h_ = th.energy_histogram(r_, N_BINS, BIN_DT)
        h_.sum().backward()
        out[where.type] = [x.detach().cpu() for x in (r_.hit, r_.poly_id, r_.energy, h_, a_.grad)]
    c, k = out["cpu"], out["cuda"]
    check(torch.equal(c[0], k[0]) and torch.equal(c[1], k[1]),
          "per-bounce hits or polygons differ from the CPU reference")
    for what, x, y in zip(("energy", "histogram", "gradient"), k[2:], c[2:]):
        check(torch.allclose(x, y, rtol=REF_RTOL, atol=REF_RTOL * float(y.abs().max())),
              f"{what} differs from the CPU reference")
    print(f"phase 4 main path: launches grid_shoot {launches[0]}, finalize_hits "
          f"{launches[1]}, energy_histogram {launches[2]}; all {N_RAYS} rays hit on "
          f"{N_BOUNCES} bounces; hist total {total:.6f} = bounce energies "
          f"{e_sum:.6f}; grad sum {float(g.sum()):.4f}, max {float(g.max()):.4e}; "
          f"{REF_RAYS}-ray CPU reference agrees")
    for r, n in zip(records, launches):
        r["launches"] = n

    # ---- phase 5: step times.
    def fwd():
        with torch.no_grad():
            step(absorption)

    def fwd_bwd():
        a_ = absorption.clone().requires_grad_()
        _, h = step(a_)
        h.sum().backward()

    fwd_ms, fb_ms = host_time(fwd), host_time(fwd_bwd)
    rays_total = N_RAYS * N_BOUNCES
    print(f"phase 5 metric on {name}: fwd {fwd_ms:.3f} ms, fwd+bwd {fb_ms:.3f} ms; "
          f"{rays_total / fb_ms / 1e3:.4f} Mrays/s fwd+bwd, "
          f"{rays_total / fwd_ms / 1e3:.4f} Mrays/s fwd "
          f"(82k-tri scene, grid DDA, 3-bounce, {N_RAYS} rays)")

    # Where one fwd+bwd step's device time goes, and how idle the card is.
    busy, per_name = step_ms(fwd_bwd, 3)
    parts = {k: kernel_ms(per_name, tag) for k, tag in (
        ("K1", "grid_shoot_kernel"), ("K2", "finalize_kernel"), ("K3", "_partials"))}
    print(f"phase 5 device time per fwd+bwd step: busy {busy:.4f} ms of {fb_ms:.3f} ms "
          f"(idle share {1 - busy / fb_ms:.3f}); K1 {parts['K1']:.4f} ms, K2 "
          f"{parts['K2']:.4f} ms, K3 {parts['K3']:.4f} ms, other kernels "
          f"{busy - sum(parts.values()):.4f} ms")

    # ---- phase 6: the Pallas probe kernels.
    records += probe_phase(dev)

    # ---- phase 7: the brute, octree, KD-tree and rope backends.
    records += backends_phase(dev, top, sp, rays, batches, absorption, hist.detach())

    # ---- phase 8: vertex gradients and the soft histogram.
    records += gradients_phase(dev, sp, rays, batches, absorption)

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
