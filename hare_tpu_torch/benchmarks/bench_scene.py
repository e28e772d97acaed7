"""The bench scene of ``bench.py`` on the port, the rays of each bounce of a
trace, and kernel times on the device by torch.profiler: what
``chip_smoke.py``, ``k1_sweep.py`` and the tests share."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["N_BOUNCES", "N_RAYS", "bench_setup", "bounce_rays", "device_ms", "profile_kernels"]

N_RAYS, N_BOUNCES, ABSORPTION = 1 << 15, 3, 0.3


def bench_setup(dev):
    """``bench.py``'s scene, grid and rays on ``dev``: ``(topology,
    SpatialPartition, rays, absorption)``."""
    import hare_tpu_torch as th
    from hare_tpu_torch.mesh import shapes

    faces = shapes.shoebox(20.0, 20.0, 20.0) + shapes.icosphere(
        6, radius=6.0, center=(10.0, 10.0, 10.0)
    )
    top = th.Topology.build(faces)
    sp = th.SpatialPartition(top, accel="grid", domain=48, device=dev)
    d = th.uniform_sphere(N_RAYS, torch.Generator().manual_seed(0), device=dev)
    o = torch.tensor([10.0, 10.0, 10.0], device=dev) + 6.5 * d
    absorption = torch.full((top.n_polys,), ABSORPTION, device=dev)
    return top, sp, th.Ray.make(o, d), absorption


def bounce_rays(sp, rays, absorption, n_bounces: int = N_BOUNCES):
    """The ray batch each bounce of one ``trace_rays`` run shoots, as the
    shoot function receives it (origins, directions, exclusions)."""
    import hare_tpu_torch as th

    seen = []

    def capture(scene, r, aux=None):
        seen.append(r)
        return sp.shoot_fn(scene, r, aux)

    with torch.no_grad():
        th.trace_rays(sp.scene, rays, absorption, n_bounces, capture, aux=sp.aux)
    return seen


def profile_kernels(fn, reps: int) -> Dict[str, Tuple[float, int]]:
    """``{kernel name: (device microseconds, launches)}`` of ``reps`` calls
    of ``fn()`` under torch.profiler, after one warm-up call.  The profiler
    now and then records no device activity at all; such a window is
    profiled again, up to three times, and then this raises."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out: Dict[str, Tuple[float, int]] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us, k = out.get(e.name, (0.0, 0))
                out[e.name] = (us + e.time_range.elapsed_us(), k + 1)
        if out:
            return out
    raise RuntimeError("the profiler recorded no device time in three windows")


def device_ms(fn, tag: str, reps: int) -> float:
    """Device milliseconds of one launch of the kernel named ``*tag*`` that
    ``fn()`` launches once a call: the mean over the launches the profiler
    recorded in ``reps`` calls."""
    times = profile_kernels(fn, reps)
    us = sum(t for name, (t, _) in times.items() if tag in name)
    n = sum(k for name, (_, k) in times.items() if tag in name)
    if n == 0:
        raise RuntimeError(f"the profiler recorded no launch of {tag!r}")
    return us / n / 1e3
