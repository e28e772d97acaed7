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
   shapes: time per call from CUDA events, and the kernel's own device
   time from torch.profiler;
4. the main path end to end, with its launch counts and invariants;
5. forward and forward+backward step times, Mrays/s, and where one step's
   device time goes (idle share of the card);
6. the four Pallas probe kernels of ``benchmarks/`` (P1 ``column_sum``,
   P2-P4 ``gather_sum``) through the port's probes
   (``hare_tpu_torch.benchmarks``) at the JAX probes' shapes: each probe
   driven once with its launch count, each kernel against its plain
   version, time per call and on the device, ns per gathered row and GB/s.

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
# Kernel vs plain version: the same f32 arithmetic, with some of it
# contracted into FMAs by nvcc — a few ulps.
RTOL, ATOL = 1e-5, 1e-5
# Rays whose winning triangle differs between K1 and its plain version may
# only be equal-t ties (|dt| within RTOL), and at most this share of rays.
MAX_TIE_SHARE = 1e-3
# K3 adds with float atomics in a varying order: per-bin sums agree to f32
# rounding, measured relative to the histogram total.
HIST_REL_TOL = 1e-5
# The small-input reference: the plain versions on the CPU, which the CPU
# tests hold against the JAX package.  Summed energies and gradients over
# thousands of lanes, in another order.
REF_RAYS, REF_RTOL = 2048, 1e-4


def cuda_time(fn, reps):
    """Mean milliseconds per call of ``fn()`` over ``reps`` calls, by CUDA
    events, after one warm-up call.  Where the host enqueues slower than the
    card runs, this is the host's time per call."""
    from hare_tpu_torch.benchmarks.pallas_probe import seconds_per_call

    return seconds_per_call(fn, "cuda", reps) * 1e3


def device_kernels(fn, reps=1):
    """Run ``fn()`` ``reps`` times under torch.profiler, after one warm-up
    call; returns {kernel name: device microseconds per call}."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us() / reps
    check(bool(out), "the profiler recorded no device time")
    return out


def kernel_ms(times, tag):
    """Device ms of the kernels whose name contains ``tag``."""
    return sum(us for name, us in times.items() if tag in name) / 1e3


def gather_phase(label, tab, idx, iters, out_dtype, call_ms):
    """Hold ``gather_sum`` against its plain version on one probe's inputs,
    time both, print one line; returns the probe's measurements."""
    from hare_tpu_torch.benchmarks import pallas_probe as pp

    k = pp.gather_sum(tab, idx, iters, out_dtype)
    p = pp.gather_sum_plain(tab, idx, iters, out_dtype)
    if tab.dtype == torch.int32:  # int32 sums that wrap, or small integers in f32
        check(torch.equal(k, p), f"{label}: gather_sum differs from its plain version")
    else:
        check(pp.sums_agree(k, p, pp.gather_sum_plain(tab.abs(), idx, iters)),
              f"{label}: gather_sum differs from its plain version beyond the f32 bound")
    err = float((k.double() - p.double()).abs().max())
    dev_ms = kernel_ms(device_kernels(lambda: pp.gather_sum(tab, idx, iters, out_dtype), 10),
                       "gather_rows")
    def plain():
        return pp.gather_sum_plain(tab, idx, iters, out_dtype)

    plain_ms = cuda_time(plain, 5)
    plain_dev_ms = sum(device_kernels(plain, 3).values()) / 1e3
    rows = idx.shape[0] * iters
    gbs = rows * tab.shape[1] * tab.element_size() / (dev_ms * 1e-3) / 1e9
    ns_dev = dev_ms * 1e6 / rows
    print(f"phase 6 {label} {tuple(tab.shape)} {str(tab.dtype)[6:]}, {idx.shape[0]} rows x "
          f"{iters}: max |diff| {err:.3e}; kernel {call_ms:.4f} ms per call ({dev_ms:.4f} ms "
          f"on the device: {ns_dev:.4f} ns per gathered row, {gbs:.1f} GB/s of rows), "
          f"plain {plain_ms:.4f} ms ({plain_dev_ms:.4f} ms on the device)")
    return dict(ms=call_ms, device_ms=dev_ms, plain_ms=plain_ms, plain_device_ms=plain_dev_ms,
                max_abs_err=err, ns_per_row=ns_dev, gbs=gbs)


def probe_phase(dev):
    """Phase 6: P1-P4 at the JAX probes' shapes; returns their four records."""
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
        dev_ms = kernel_ms(device_kernels(lambda: pp.column_sum(x), 10), "column_sum")
        plain_ms = cuda_time(lambda: pp.column_sum_plain(x), 50)
        plain_dev_ms = sum(device_kernels(lambda: pp.column_sum_plain(x), 10).values()) / 1e3
        gbs = x.numel() * 4 / (dev_ms * 1e-3) / 1e9
        by_mb[mb] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         plain_device_ms=plain_dev_ms, gbs=gbs)
        print(f"phase 6 P1 column_sum {mb} MB ({x.shape[0]} x 192 f32): kernel {ms:.4f} ms "
              f"per call ({dev_ms:.4f} ms on the device, {gbs:.1f} GB/s), plain "
              f"{plain_ms:.4f} ms ({plain_dev_ms:.4f} ms on the device)")
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
                    device_ms=big["device_ms"], plain_device_ms=big["plain_device_ms"],
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
           for k in ("ms", "device_ms", "plain_ms", "plain_device_ms")}, calls=calls))
    return records


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def to_device(nt, device):
    """A NamedTuple of tensors (Scene, VoxelGrid, Ray) on ``device``."""
    return type(nt)(*(x.to(device) if isinstance(x, torch.Tensor) else x for x in nt))


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")

    import hare_tpu_torch as th
    from hare_tpu_torch.accel import common, voxel
    from hare_tpu_torch.kernels import build
    from hare_tpu_torch.mesh import shapes
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
    faces = shapes.shoebox(20.0, 20.0, 20.0) + shapes.icosphere(
        6, radius=6.0, center=(10.0, 10.0, 10.0)
    )
    top = th.Topology.build(faces)
    sp = th.SpatialPartition(top, accel="grid", domain=48, device=dev)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    check(top.n_tris == 81932, f"bench scene has {top.n_tris} triangles, not 81,932")
    grid = sp.struct
    print(f"phase 2 scene: {top.n_tris} tris, {top.n_polys} polys, grid {grid.dims}, "
          f"{grid.win_geom.shape[0]} window rows; host build {host_s:.2f} s")

    gen = torch.Generator().manual_seed(0)
    d = th.uniform_sphere(N_RAYS, gen, device=dev)
    o = torch.tensor([10.0, 10.0, 10.0], device=dev) + 6.5 * d
    rays = th.Ray.make(o, d)
    absorption = torch.full((top.n_polys,), ABSORPTION, device=dev)

    # ---- phase 3: each kernel against its plain version, main-path shapes.
    records = []
    # K1 on the first bounce's rays.
    bt_k, btri_k = voxel.grid_shoot(rays, grid)
    bt_p, btri_p = voxel.grid_shoot_plain(rays, grid)
    hit = torch.isfinite(bt_p)
    check(torch.equal(torch.isfinite(bt_k), hit), "K1 hit mask differs from its plain version")
    check(bool(hit.all()), "K1: a first-bounce ray missed in the closed room")
    dt = (bt_k - bt_p).abs()
    k1_err = float(dt.max())
    flips = btri_k != btri_p
    n_flips = int(flips.sum())
    check(bool((dt <= ATOL + RTOL * bt_p.abs()).all()), f"K1 t differs by {k1_err}")
    check(n_flips <= MAX_TIE_SHARE * N_RAYS, f"K1: {n_flips} tri_id mismatches")
    ms = cuda_time(lambda: voxel.grid_shoot(rays, grid), 20)
    dev_ms = kernel_ms(device_kernels(lambda: voxel.grid_shoot(rays, grid), 10),
                       "grid_shoot_kernel")
    plain_ms = cuda_time(lambda: voxel.grid_shoot_plain(rays, grid), 3)
    print(f"phase 3 K1 grid_shoot: tri_id mismatches {n_flips} (equal-t ties), "
          f"max |dt| {k1_err:.3e}; kernel {ms:.4f} ms per call ({dev_ms:.4f} ms on "
          f"the device), plain {plain_ms:.4f} ms")
    records.append(dict(name="grid_shoot", route="cuda",
                        source="hare_tpu_torch/kernels/csrc/grid_shoot.cu",
                        replaces="hare_tpu/accel/voxel.py:414", max_abs_err=k1_err,
                        ms=ms, plain_ms=plain_ms, device_ms=dev_ms))

    # K2 on K1's winners.
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
    dev_ms = kernel_ms(device_kernels(
        lambda: common.finalize_hits(sp.scene, rays, bt_k, btri_k), 10), "finalize_kernel")
    plain_ms = cuda_time(lambda: common.finalize_hits_plain(sp.scene, rays, bt_k, btri_k), 20)
    print("phase 3 K2 finalize_hits: max |diff| " +
          ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) +
          f"; kernel {ms:.4f} ms per call ({dev_ms:.4f} ms on the device), "
          f"plain {plain_ms:.4f} ms")
    records.append(dict(name="finalize_hits", route="cuda",
                        source="hare_tpu_torch/kernels/csrc/finalize_hits.cu",
                        replaces="hare_tpu/accel/common.py:437",
                        max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
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

    ms = cuda_time(k3, 100)
    dev_ms = kernel_ms(device_kernels(k3, 10), "histogram_kernel")
    plain_ms = cuda_time(
        lambda: bounce.histogram_plain(res.energy, res.time, res.hit, N_BINS, BIN_DT), 100)
    print(f"phase 3 K3 energy_histogram: max |diff| / total {k3_err / total:.3e}; "
          f"kernel {ms:.4f} ms per call ({dev_ms:.4f} ms on the device), "
          f"plain {plain_ms:.4f} ms")
    records.append(dict(name="energy_histogram", route="cuda",
                        source="hare_tpu_torch/kernels/csrc/energy_histogram.cu",
                        replaces="hare_tpu/trace/bounce.py:294", max_abs_err=k3_err,
                        ms=ms, plain_ms=plain_ms, device_ms=dev_ms))

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

    def host_time(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / reps * 1e3

    fwd_ms, fb_ms = host_time(fwd), host_time(fwd_bwd)
    rays_total = N_RAYS * N_BOUNCES
    print(f"phase 5 metric on {name}: fwd {fwd_ms:.3f} ms, fwd+bwd {fb_ms:.3f} ms; "
          f"{rays_total / fb_ms / 1e3:.4f} Mrays/s fwd+bwd, "
          f"{rays_total / fwd_ms / 1e3:.4f} Mrays/s fwd "
          f"(82k-tri scene, grid DDA, 3-bounce, {N_RAYS} rays)")

    # Where one fwd+bwd step's device time goes, and how idle the card is.
    times = device_kernels(fwd_bwd, 3)
    busy = sum(times.values()) / 1e3
    parts = {k: kernel_ms(times, tag) for k, tag in (
        ("K1", "grid_shoot_kernel"), ("K2", "finalize_kernel"), ("K3", "histogram_kernel"))}
    print(f"phase 5 device time per fwd+bwd step: busy {busy:.4f} ms of {fb_ms:.3f} ms "
          f"(idle share {1 - busy / fb_ms:.3f}); K1 {parts['K1']:.4f} ms, K2 "
          f"{parts['K2']:.4f} ms, K3 {parts['K3']:.4f} ms, other kernels "
          f"{busy - sum(parts.values()):.4f} ms")

    # ---- phase 6: the Pallas probe kernels.
    records += probe_phase(dev)

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
