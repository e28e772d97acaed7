"""One run of one cell: set-up, the measured (or traced) window, the output
check and the metrics, as ``run.py`` prints them."""

from __future__ import annotations

import os
import resource
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import counts, devtrace, judge, rays, reference, shapes
from .cells import Cell, step_of
from .devtrace import STEP
from .program import System

# The traced run profiles at most this many seconds of steps: enough for
# hundreds of steps in every cell, and short enough to read back in
# seconds.
TRACE_SECONDS = 5.0
WARMUP_STEPS = 2
# Where the program keeps the kernel library it builds on first use.
KERNEL_BUILD = Path(__file__).resolve().parents[1] / "hare_tpu_torch" / "_build"


def _libraries() -> set:
    return set(KERNEL_BUILD.glob("*.so"))


def set_up(cell: Cell, seed: int, device) -> SimpleNamespace:
    """What set-up makes: the faces, the program's scene and structure
    (``system``), the ray origin and the seed's pool, with every shape of
    the step warmed up (the first run in a checkout builds the kernels
    here)."""
    cfg, traffic = cell.config, cell.traffic
    faces = shapes.scene(cfg["scene"])
    system = System(faces, cfg, traffic, device)
    n = traffic["rays_per_step"]
    origin = torch.tensor(cfg["source"], dtype=torch.float32, device=device).expand(n, 3)
    origin = origin.contiguous()
    dirs = rays.pool(seed, n, traffic["pool_batches"], device)
    batches = system.rays(origin, dirs)
    for i in range(WARMUP_STEPS):
        system.step(batches[i % len(batches)])
        _sync(device)
    return SimpleNamespace(faces=faces, system=system, origin=origin, dirs=dirs, batches=batches)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def host_use() -> Dict[str, float]:
    """This process's CPU seconds (all threads, and the calling thread), the
    seconds its threads waited for a CPU, its involuntary context switches
    and the machine's stolen seconds (Linux ``/proc``).  Read before and
    after a window, they tell a host that ran the steps slower from one
    that left them waiting."""
    wait = 0.0
    for task in Path("/proc/self/task").iterdir():
        try:
            wait += int((task / "schedstat").read_text().split()[1]) / 1e9
        except (OSError, IndexError, ValueError):
            pass
    with open("/proc/stat") as f:
        steal = int(f.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    return {"process_cpu_s": time.process_time(), "thread_cpu_s": time.thread_time(),
            "wait_s": wait, "switches": resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw,
            "steal_s": steal}


def window(s: SimpleNamespace, seconds: float, device):
    """Closed-loop steps for ``seconds``: each step the next batch of the
    pool, ending in a synchronise.  Returns the last step's outputs and
    batch, every step's time in ms (CUDA events from its first command to
    its last on the device), and the window's wall seconds."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    step_ms, i, out, k = [], 0, None, 0
    t0 = time.perf_counter()
    while True:
        k = i % len(s.batches)
        with record_function(STEP):
            ta = time.perf_counter()
            if cuda:
                e0.record()
            out = s.system.step(s.batches[k])
            if cuda:
                e1.record()
                torch.cuda.synchronize()
        t = time.perf_counter()
        step_ms.append(e0.elapsed_time(e1) if cuda else (t - ta) * 1e3)
        i += 1
        if t - t0 >= seconds:
            return out, k, step_ms, t - t0


def traced_window(s: SimpleNamespace, seconds: float, device):
    """:func:`window` under torch.profiler (CPU and CUDA activity), at most
    ``TRACE_SECONDS``; returns its results and the read trace."""
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        got = window(s, min(seconds, TRACE_SECONDS), device)
    return got, devtrace.collect(prof)


def device_window(s: SimpleNamespace, seconds: float, device, report=sys.stderr):
    """:func:`window` with the profiler recording the device's activity
    alone, for end-to-end metrics of the device's time over every step;
    returns its results and the device's operations, or None off a card."""
    if torch.device(device).type != "cuda":
        return window(s, seconds, device), None
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = window(s, seconds, device)
    t0 = time.perf_counter()
    ops = devtrace.collect_device(prof, len(got[2]))
    print(f"device window: {len(ops.kernels)} kernels, {len(ops.copies)} copies, busy "
          f"{devtrace.busy_ns(ops) / 1e6 / ops.steps:.5f} ms a step, read in "
          f"{time.perf_counter() - t0:.1f} s", file=report)
    return got, ops


def check(cell: Cell, s: SimpleNamespace, out: judge.StepOutputs, k: int, seed: int, device,
          report=sys.stderr) -> Dict:
    """The numbers compared for the step ``out`` on batch ``k``, once the
    program's scene, structure and the rest of the pool are freed."""
    cfg, traffic = cell.config, cell.traffic
    origin, dirs = s.origin, s.dirs[k]
    absorption = s.system.absorption.detach()
    faces = s.faces
    s.system = s.batches = s.dirs = None
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sc = reference.build(faces, device)
    sample = rays.sample(seed, traffic["rays_per_step"], cfg["check_rays"])
    got = judge.numbers(sc, origin, dirs, absorption, out, sample, cfg, traffic,
                        _mesh(faces, traffic, device))
    print(f"check: {len(sample)} rays re-traced, the whole batch's lanes worked out, in "
          f"{time.perf_counter() - t0:.3f} s", file=report)
    return got


def _mesh(faces, traffic: Dict, device):
    """The welded faces, where the traffic's step is w.r.t. the vertices."""
    return reference.weld(faces, device) if step_of(traffic).wrt_vertices else None


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        report=sys.stderr) -> Dict:
    """One run of ``cell``: the result line as a dict (``checks`` last)."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    libraries = _libraries()
    s = set_up(cell, seed, device)
    setup_s = time.time() - t_start
    # A run whose set-up built the kernel library pays the build in setup_s.
    built = bool(_libraries() - libraries)
    tr = dev_ops = None
    use0 = host_use()
    if trace:
        (out, k, step_ms, window_s), tr = traced_window(s, seconds, device)
    elif any(m.device_window for m in cell.end_to_end):
        (out, k, step_ms, window_s), dev_ops = device_window(s, seconds, device, report)
    else:
        out, k, step_ms, window_s = window(s, seconds, device)
    use = {n: v - use0[n] for n, v in host_use().items()}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    q = np.percentile(step_ms, [5, 50, 95, 100])
    half = len(step_ms) // 2
    print(f"set-up: {setup_s:.3f} s, kernels built: {built}", file=report)
    print(f"window: {len(step_ms)} steps in {window_s:.3f} s; step ms p5 {q[0]:.4f} median "
          f"{q[1]:.4f} p95 {q[2]:.4f} max {q[3]:.4f}; mean ms first half "
          f"{np.mean(step_ms[:half] or [0]):.4f} second half {np.mean(step_ms[half:]):.4f}",
          file=report)
    print(f"host over the window and its reading: process cpu {use['process_cpu_s']:.3f} s, main thread cpu "
          f"{use['thread_cpu_s']:.3f} s, threads waiting for a cpu {use['wait_s']:.3f} s, "
          f"involuntary switches {use['switches']}, machine steal {use['steal_s']:.2f} s",
          file=report)
    got = check(cell, s, out, k, seed, device, report)
    ok = judge.verdict(got, cell.limits)
    ctx = SimpleNamespace(steps=len(step_ms), step_ms=step_ms, window_s=window_s,
                          setup_s=setup_s, rays=cell.traffic["rays_per_step"],
                          bounces=cell.traffic["bounces"], trace=tr, device=dev_ops,
                          counts=counts, devtrace=devtrace)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.read(ctx)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": ok, "attempted": len(step_ms), "failed": 0, "metrics": metrics,
              "device": dev, "setup_built_kernels": built}
    if tr is not None:
        dev["busy_s"] = devtrace.busy_ns(tr) / 1e9
        dev["window_s"] = (tr.window[1] - tr.window[0]) / 1e9
        result["breakdown"] = devtrace.breakdown(tr)
        print(f"trace: {len(tr.kernels)} kernels, {tr.linked:.4f} matched to their launch, "
              f"{tr.steps} steps", file=report)
    result["checks"] = {n: {"value": got[n], "limit": cell.limits[n]} for n in judge.NUMBERS}
    for n in judge.NUMBERS:
        print(f"check {n} {got[n]!r} limit {cell.limits[n]!r}", file=report)
    return result


def forbidden_modules() -> list:
    """Top-level names of loaded modules that must not be: JAX, its
    libraries, the JAX package and its benchmarks."""
    bad = {"jax", "jaxlib", "flax", "hare_tpu", "benchmarks"}
    return sorted({m.split(".")[0] for m in list(sys.modules)} & bad)


def process_start() -> float:
    """The wall-clock time this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
    return boot + ticks / os.sysconf("SC_CLK_TCK")


def control_run(cell: Cell, seeds, device, report=sys.stderr) -> list:
    """The readings the limits are set from, in one process: set-up once,
    then for each seed its pool, a warm step and one more, and the numbers
    of that step; and on the same step the control, the reference in
    bfloat16 put in the program's place.  W.r.t. the vertices, ``detail``
    holds what the check left out (``judge.comparable``) and the two
    numbers with nothing left out."""
    cfg, traffic = cell.config, cell.traffic
    s = set_up(cell, seeds[0], device)
    sc = reference.build(s.faces, device)
    sc_low = reference.build(s.faces, device, dtype=torch.bfloat16)
    mesh = _mesh(s.faces, traffic, device)
    absorption = s.system.absorption.detach()
    n = traffic["rays_per_step"]
    rows = []
    for seed in seeds:
        s.dirs = rays.pool(seed, n, 1, device)
        s.batches = s.system.rays(s.origin, s.dirs)
        s.system.step(s.batches[0])
        out = s.system.step(s.batches[0])
        _sync(device)
        sample = rays.sample(seed, n, cfg["check_rays"])
        t0 = time.perf_counter()
        detail = {}
        prog = judge.numbers(sc, s.origin, s.dirs[0], absorption, out, sample, cfg, traffic,
                             mesh, detail)
        print(f"check of seed {seed}: {time.perf_counter() - t0:.3f} s", file=report)
        ctl = judge.control_numbers(sc, sc_low, s.origin, s.dirs[0], absorption, out, sample,
                                    cfg, traffic, mesh)
        row = {"seed": seed, "program": prog, "control": ctl, "detail": detail}
        print(row, file=report, flush=True)
        rows.append(row)
    return rows
