"""The bench scene of ``bench.py`` on the port, the rays of each bounce of a
trace, and kernel times on the device by torch.profiler: what
``chip_smoke.py``, ``kernel_sweep.py`` and the tests share."""

from __future__ import annotations

import time
from typing import Dict, Tuple

import torch

__all__ = ["N_BOUNCES", "N_RAYS", "bench_setup", "bounce_inputs", "bounce_rays", "device_ms",
           "profile_kernels"]

N_RAYS, N_BOUNCES, ABSORPTION = 1 << 15, 3, 0.3
# Profiler windows tried before a device time is given up (profile_kernels).
WINDOWS = 5


def bench_setup(dev, n: int = N_RAYS):
    """``bench.py``'s scene, grid and ``n`` rays on ``dev``: ``(topology,
    SpatialPartition, rays, absorption)``."""
    import hare_tpu_torch as th
    from hare_tpu_torch.mesh import shapes

    faces = shapes.shoebox(20.0, 20.0, 20.0) + shapes.icosphere(
        6, radius=6.0, center=(10.0, 10.0, 10.0)
    )
    top = th.Topology.build(faces)
    sp = th.SpatialPartition(top, accel="grid", domain=48, device=dev)
    d = th.uniform_sphere(n, torch.Generator().manual_seed(0), device=dev)
    o = torch.tensor([10.0, 10.0, 10.0], device=dev) + 6.5 * d
    absorption = torch.full((top.n_polys,), ABSORPTION, device=dev)
    return top, sp, th.Ray.make(o, d), absorption


def bounce_rays(sp, rays, absorption, n_bounces: int = N_BOUNCES, **trace_kw):
    """The ray batch each bounce of one ``trace_rays`` run shoots, as the
    shoot function receives it (origins, directions, exclusions);
    ``trace_kw`` (``scattering``, ``generator``) go to ``trace_rays``."""
    import hare_tpu_torch as th

    seen = []

    def capture(scene, r, aux=None):
        seen.append(r)
        return sp.shoot_fn(scene, r, aux)

    with torch.no_grad():
        th.trace_rays(sp.scene, rays, absorption, n_bounces, capture, aux=sp.aux, **trace_kw)
    return seen


def bounce_inputs(sp, rays, absorption, n_bounces: int = N_BOUNCES, **trace_kw):
    """What each bounce step of one ``trace_rays`` run receives (K4 on CUDA
    tensors): ``(state, record, draws, sound_speed, tri_meta)`` a bounce
    (``trace.bounce.record_steps``); ``trace_kw`` (``scattering``,
    ``generator``) go to ``trace_rays``."""
    import hare_tpu_torch as th
    from hare_tpu_torch.trace import bounce

    with torch.no_grad(), bounce.record_steps() as steps:
        th.trace_rays(sp.scene, rays, absorption, n_bounces, sp.shoot_fn, aux=sp.aux,
                      **trace_kw)
    return steps


def profile_kernels(fn, reps: int) -> Dict[str, Tuple[float, int]]:
    """``{kernel name: (device microseconds, launches)}`` of ``reps`` calls
    of ``fn()`` under torch.profiler, after one warm-up call.  The profiler
    now and then records no device activity at all; such a window is
    profiled again after a pause, up to ``WINDOWS`` times, and then this
    raises.  It also now and then drops one launch
    of a window, so a launch count may fall short of the launches made."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(WINDOWS):
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
        time.sleep(0.2)
    raise RuntimeError(f"the profiler recorded no device time in {WINDOWS} windows")


def device_ms(fn, tag: str, reps: int) -> float:
    """Device milliseconds of one call of ``fn()`` in the kernels named
    ``*tag*``, each launched once a call: for each such name the mean over
    the launches the profiler recorded in ``reps`` calls, summed."""
    times = profile_kernels(fn, reps)
    means = [t / k for name, (t, k) in times.items() if tag in name]
    if not means:
        raise RuntimeError(f"the profiler recorded no launch of {tag!r}")
    return sum(means) / 1e3
