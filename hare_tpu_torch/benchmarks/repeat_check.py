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
and after.  Where the checkout's port takes vertex gradients
(``Scene.with_vertices``), it does the same w.r.t. the vertices with the
soft histogram.  Prints one JSON line.

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


def vertex_step(th, sp, rays, absorption, n_bounces: int, n_bins: int = N_BINS):
    """One fwd+bwd step w.r.t. the vertices, soft bins, loss
    ``sum(h * arange(n_bins))``: ``(histogram, gradient)``."""
    import torch

    weight = torch.arange(n_bins, dtype=torch.float32, device=rays.origin.device)

    def step():
        v = sp.scene.vertices.clone().requires_grad_()
        res = th.trace_rays(sp.scene.with_vertices(v), rays, absorption, n_bounces, sp.shoot_fn,
                            aux=sp.aux)
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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[2])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.tree.resolve()))
    import torch

    import hare_tpu_torch as th
    from hare_tpu_torch.benchmarks.bench_scene import N_BOUNCES, bench_setup

    if not torch.cuda.is_available():
        raise RuntimeError("the bench step is run on the card")
    _, sp, rays, absorption = bench_setup(torch.device("cuda"))
    step = absorption_step(th, sp, rays, absorption, N_BOUNCES)
    hist_diff, grad_diff = max_diffs(step, STEPS)
    rec = {"tree": str(args.tree), "package": str(Path(th.__file__).parent),
           "device": torch.cuda.get_device_name(0), "steps": STEPS,
           "absorption": {"hist_max_abs_diff": hist_diff, "grad_max_abs_diff": grad_diff,
                          "step_ms": step_ms(step, REPS), "reps": REPS}}
    if hasattr(sp.scene, "with_vertices"):
        vstep = vertex_step(th, sp, rays, absorption, N_BOUNCES)
        hist_diff, grad_diff = max_diffs(vstep, STEPS)
        rec["vertices_soft"] = {"hist_max_abs_diff": hist_diff, "grad_max_abs_diff": grad_diff,
                                "step_ms": step_ms(vstep, REPS), "reps": REPS}
    print(json.dumps({"repeat_check": rec}))
    return rec


if __name__ == "__main__":
    main()
