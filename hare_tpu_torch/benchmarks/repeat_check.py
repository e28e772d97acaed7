"""Bitwise repeats of the bench step's histogram and gradients, and the
step's time, in this checkout or another.

    python hare_tpu_torch/benchmarks/repeat_check.py [--tree DIR]

Imports ``hare_tpu_torch`` from the checkout ``DIR`` (default: the one that
holds this file), builds the bench scene (``bench.py``: 82k triangles,
grid ``domain=48``, 32,768 rays, 3 bounces, 1024 bins) on the card and runs
``STEPS`` fwd+bwd steps of its main path w.r.t. per-polygon absorption.  It
reports the largest |difference| of each step's histogram and gradient from
the first step's — 0 where every sum has a fixed order — and the wall
milliseconds a step over ``REPS`` more steps, the card synchronised before
and after, and the kernels a step launches with their device time, by
torch.profiler.  Where the checkout's port takes vertex gradients
(``Scene.with_vertices``), it does the same w.r.t. the vertices with the
soft histogram, and counts the fill kernels (``FillFunctor``: zeros that
autograd or a wrapper writes) one such step launches, with their device
time.  Then eval config 3's step w.r.t. absorption (the concert hall,
octree, 1M rays from (15, 24, 8), 3 bounces): its wall time and kernels a
step.  Prints one JSON line.

The loss is the first moment ``sum(h * arange(n_bins))``, not the
histogram's sum: under the sum every ray of a bounce sends the same
cotangent to its polygon's absorption (uniform absorption), and equal
addends sum to the same bits in any order, so the sum would hide an
order that changes.
"""

import argparse
import json
import sys
import time
from pathlib import Path

N_BINS, BIN_DT = 1024, 1e-3
# Repeated steps compared with the first; steps timed after a warm-up.
STEPS, REPS = 5, 20


def max_diffs(step, steps: int):
    """Run ``step()`` (a tuple of tensors) ``steps`` times: for each output,
    the largest |difference| of a later run from the first."""
    first = [x.detach().clone() for x in step()]
    diffs = [0.0] * len(first)
    for _ in range(steps - 1):
        for k, (x, y) in enumerate(zip(step(), first)):
            diffs[k] = max(diffs[k], float((x.detach() - y).abs().max()))
    return diffs


def absorption_step(th, sp, rays, absorption, n_bounces: int):
    """One fwd+bwd step w.r.t. absorption, hard bins, loss
    ``sum(h * arange(N_BINS))``: ``(histogram, gradient)``."""
    import torch

    weight = torch.arange(N_BINS, dtype=torch.float32, device=rays.origin.device)

    def step():
        a = absorption.clone().requires_grad_()
        res = th.trace_rays(sp.scene, rays, a, n_bounces, sp.shoot_fn, aux=sp.aux)
        hist = th.energy_histogram(res, N_BINS, BIN_DT)
        (hist * weight).sum().backward()
        return hist, a.grad

    return step


def vertex_step(th, sp, rays, absorption, n_bounces: int, n_bins: int = N_BINS,
                remat: bool = False):
    """One fwd+bwd step w.r.t. the vertices, soft bins, loss
    ``sum(h * arange(n_bins))``, per-bounce remat where asked:
    ``(histogram, gradient)``."""
    import torch

    weight = torch.arange(n_bins, dtype=torch.float32, device=rays.origin.device)

    def step():
        v = sp.scene.vertices.clone().requires_grad_()
        res = th.trace_rays(sp.scene.with_vertices(v), rays, absorption, n_bounces, sp.shoot_fn,
                            aux=sp.aux, remat=remat)
        hist = th.energy_histogram(res, n_bins, BIN_DT, soft=True)
        (hist * weight).sum().backward()
        return hist, v.grad

    return step


def step_ms(step, reps: int) -> float:
    """Wall milliseconds a call of ``step()`` after one warm-up call."""
    import torch

    step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3


def kernels_a_step(step, reps: int = 3) -> dict:
    """Launches and device milliseconds of all the kernels a call of
    ``step()`` launches, over ``reps`` profiled calls."""
    from hare_tpu_torch.benchmarks.bench_scene import profile_kernels

    times = profile_kernels(step, reps).values()
    return {"launches": sum(k for _, k in times) / reps,
            "device_ms": sum(us for us, _ in times) / reps / 1e3, "reps": reps}


def fill_kernels(step, reps: int = 3) -> dict:
    """Launches and device milliseconds a call of ``step()`` spends in fill
    kernels (torch's ``FillFunctor``), over ``reps`` profiled calls."""
    from hare_tpu_torch.benchmarks.bench_scene import profile_kernels

    fills = [(us, k) for name, (us, k) in profile_kernels(step, reps).items()
             if "FillFunctor" in name]
    return {"launches": sum(k for _, k in fills) / reps,
            "device_ms": sum(us for us, _ in fills) / reps / 1e3, "reps": reps}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[2])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.tree.resolve()))
    import torch

    import hare_tpu_torch as th
    from hare_tpu_torch.benchmarks.bench_scene import N_BOUNCES, bench_setup
    from hare_tpu_torch.mesh import shapes

    if not torch.cuda.is_available():
        raise RuntimeError("the bench step is run on the card")
    _, sp, rays, absorption = bench_setup(torch.device("cuda"))
    step = absorption_step(th, sp, rays, absorption, N_BOUNCES)
    hist_diff, grad_diff = max_diffs(step, STEPS)
    rec = {"tree": str(args.tree), "package": str(Path(th.__file__).parent),
           "device": torch.cuda.get_device_name(0), "steps": STEPS,
           "absorption": {"hist_max_abs_diff": hist_diff, "grad_max_abs_diff": grad_diff,
                          "step_ms": step_ms(step, REPS), "reps": REPS,
                          "kernels": kernels_a_step(step)}}
    if hasattr(sp.scene, "with_vertices"):
        vstep = vertex_step(th, sp, rays, absorption, N_BOUNCES)
        hist_diff, grad_diff = max_diffs(vstep, STEPS)
        rec["vertices_soft"] = {"hist_max_abs_diff": hist_diff, "grad_max_abs_diff": grad_diff,
                                "step_ms": step_ms(vstep, REPS), "reps": REPS,
                                "fill_kernels": fill_kernels(vstep),
                                "kernels": kernels_a_step(vstep)}
    # Eval config 3 as benchmarks.configs.config3_setup builds it, written
    # out here: an older checkout imported through --tree lacks that function.
    hall = th.Topology.build(shapes.concert_hall())
    sp3 = th.SpatialPartition(hall, accel="octree", device="cuda")
    d3 = th.uniform_sphere(1_000_000, torch.Generator().manual_seed(0), device="cuda")
    r3 = th.Ray.make(torch.tensor((15.0, 24.0, 8.0), device="cuda").expand(d3.shape).contiguous(),
                     d3)
    step3 = absorption_step(th, sp3, r3, torch.full((hall.n_polys,), 0.3, device="cuda"),
                            N_BOUNCES)
    rec["config3_absorption"] = {"step_ms": step_ms(step3, 5), "reps": 5,
                                 "kernels": kernels_a_step(step3)}
    print(json.dumps({"repeat_check": rec}))
    return rec


if __name__ == "__main__":
    main()
