"""Cost of one ``scatter_add_ordered`` call, in this checkout or another.

    python hare_tpu_torch/benchmarks/scatter_time.py [--tree DIR]

Imports ``hare_tpu_torch`` from the checkout ``DIR`` (default: the one that
holds this file), builds the bench scene (``bench.py``: 82k triangles, grid
``domain=48``, 32,768 rays) on the card, shoots the first bounce and takes
the two scatters of the bench gradient paths on its rays: A3's corner
cotangents onto the vertices (98,304 x 3 values) and seeded values onto
the polygons' absorption keys (32,768 values into 81,932 keys); eval
config 3's absorption keys (1M rays' first polygons in the concert hall,
octree); eval config 4's A3 corner cotangents of its first bounce
(98,304 x 3 values into 327,698 vertex keys, SAH KD tree); and eval config
5's absorption keys of its first bounce, drawn (``config5_keys``: 2^20
values into 5,242,892 keys).  For each, and for one ``index_add_`` on the
same inputs (its yardstick):

- host microseconds a call: wall time over ``REPS`` calls, the card
  synchronised before and after (the card runs each call faster than the
  host issues it, so this is the wrapper's own cost);
- device milliseconds a call: every kernel the call launches (a sort's
  too, where the checkout's wrapper sorts), by torch.profiler, with each
  kernel's milliseconds and launches a call (each pass of the kernel by
  its name);
- the keys used and, where the checkout's wrapper tells how its pass 2
  runs, the keys a pass-2 block takes, whether it reads listed (range,
  chunk) pairs, and how many pairs there are.

Run it on this tree and a parent checkout in turns.  Prints one JSON line.
"""

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

SEED = 7
# Eval config 3 (benchmarks/configs.py): rays and source point.
HALL_RAYS, HALL_ORIGIN = 1_000_000, (15.0, 24.0, 8.0)
# Eval config 5 (benchmarks/configs.py big_scene("5M"), config5_setup): its
# polygons are the shell's 12 triangles (keys 0-11), then four icospheres
# of radius 6 and 1,310,720 triangles each; its rays leave (20, 20, 20).
CONFIG5_POLYS, CONFIG5_SHELL, CONFIG5_SPHERE = 5_242_892, 12, 1_310_720
CONFIG5_CENTRES, CONFIG5_RADIUS = ((10, 10, 10), (30, 10, 12), (10, 30, 14), (28, 28, 28)), 6.0
CONFIG5_SOURCE, CONFIG5_RAYS = (20.0, 20.0, 20.0), 1 << 20
# Calls profiled for the device time; a sort launches some kernels more
# than once a call, so the time a call is the window's sum over the calls.
PROFILED = 20
# Calls timed on the host's clock.
REPS = 300


def host_us(fn) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(REPS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / REPS * 1e6


def config5_keys(seed: int) -> np.ndarray:
    """Config 5's bounce-1 polygon keys, drawn: a sphere at distance d takes
    (1 - sqrt(1 - (r / d)^2)) / 2 of the uniform directions (15% for the
    four), each hit uniform over the (1 - r / d) / 2 of its faces it shows,
    taken as a block of its keys; the shell's 12 keys take the rest, in
    long runs.  About 150k keys used, as in chip_smoke.py phase 12e."""
    rng = np.random.default_rng(seed)
    share, shown = [], []
    for c in CONFIG5_CENTRES:
        d = math.dist(c, CONFIG5_SOURCE)
        share.append((1 - math.sqrt(1 - (CONFIG5_RADIUS / d) ** 2)) / 2)
        shown.append(int((1 - CONFIG5_RADIUS / d) / 2 * CONFIG5_SPHERE))
    which = rng.choice(len(share) + 1, CONFIG5_RAYS, p=[1 - sum(share)] + share)
    keys = rng.integers(0, CONFIG5_SHELL, CONFIG5_RAYS)
    for s, n in enumerate(shown):
        hit = which == s + 1
        keys[hit] = CONFIG5_SHELL + s * CONFIG5_SPHERE + rng.integers(0, n, int(hit.sum()))
    return keys.astype(np.int32)


def corner_cotangents(scene, rays, best_tri, hr, g):
    """A3's corner cotangents (vertex keys, (M, 3) values) of seeded
    cotangents on the hits ``hr`` of ``rays``."""
    import torch

    from hare_tpu_torch.accel import common

    n = rays.origin.shape[0]
    cts = tuple(torch.randn(shape, generator=g, device=rays.origin.device)
                for shape in ((n,), (n,), (n,), (n, 3), (n, 3)))
    k = common.finalize_hits_bwd(scene.vertices, scene.tri_meta, best_tri, hr.t, hr.hit,
                                 rays.origin, rays.direction, cts)
    return k[2], k[3]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[2])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.tree.resolve()))
    import torch

    import hare_tpu_torch as th
    from hare_tpu_torch.accel import common, scatter, tree, voxel
    from hare_tpu_torch.benchmarks import configs
    from hare_tpu_torch.benchmarks.bench_scene import bench_setup, profile_kernels
    from hare_tpu_torch.mesh import shapes

    if not torch.cuda.is_available():
        raise RuntimeError("the scatter is timed on the card")
    dev = torch.device("cuda")
    _, sp, rays, _ = bench_setup(dev)
    scene = sp.scene
    best_t, best_tri = voxel.grid_shoot(rays, sp.struct)
    hr = common.finalize_hits(scene, rays, best_t, best_tri)
    g = torch.Generator(device=dev).manual_seed(SEED)
    n = rays.origin.shape[0]
    corners = corner_cotangents(scene, rays, best_tri, hr, g)
    pid = torch.clamp(hr.poly_id, min=0)
    # Eval config 3's first bounce: 1M rays from one point of the concert
    # hall (octree), their polygons the absorption gradient's keys.
    hall = th.Topology.build(shapes.concert_hall())
    sp3 = th.SpatialPartition(hall, accel="octree", device=dev)
    d3 = th.uniform_sphere(HALL_RAYS, torch.Generator().manual_seed(0), device=dev)
    o3 = torch.tensor(HALL_ORIGIN, device=dev).expand(HALL_RAYS, 3).contiguous()
    pid3 = torch.clamp(sp3.shoot(th.Ray.make(o3, d3)).poly_id, min=0)
    # Eval config 4's first bounce: its corners fall on ~15k of 327,698
    # vertex keys.
    c4 = configs.config4_setup(dev)
    scene4, rays4 = c4.partition.scene, c4.rays
    best_t4, best_tri4 = tree.tree_shoot(rays4, c4.partition.struct)
    hr4 = common.finalize_hits(scene4, rays4, best_t4, best_tri4)
    cases = {"A3 bounce 1 corners": corners + (scene.vertices.shape[0],),
             "absorption gradient": (pid, torch.randn(n, generator=g, device=dev),
                                     scene.n_polys),
             "config 3 absorption": (pid3, torch.randn(HALL_RAYS, generator=g, device=dev),
                                     hall.n_polys),
             "config 4 A3 bounce 1 corners": corner_cotangents(scene4, rays4, best_tri4, hr4, g)
             + (scene4.vertices.shape[0],),
             "config 5 absorption (drawn)": (
                 torch.from_numpy(config5_keys(SEED)).to(dev),
                 torch.randn(CONFIG5_RAYS, generator=g, device=dev), CONFIG5_POLYS)}
    plan = getattr(scatter, "pass2_plan", None)  # absent in a checkout before it
    rec = {"tree": str(args.tree), "package": str(Path(th.__file__).parent),
           "device": torch.cuda.get_device_name(0), "reps": REPS}
    for label, (keys, values, n_keys) in cases.items():
        lib_out, lib_idx = torch.zeros((n_keys,) + tuple(values.shape[1:]), device=dev), keys.long()
        calls = {"scatter_add_ordered": lambda: scatter.scatter_add_ordered(keys, values, n_keys),
                 "index_add_": lambda: lib_out.index_add_(0, lib_idx, values)}
        rec[label] = {"values": keys.numel(), "cols": 1 if values.dim() == 1 else values.shape[1],
                      "keys": n_keys, "keys_used": int(torch.unique(keys).numel())}
        if plan is not None:
            key_range, listed = plan(keys.numel(), n_keys)
            rec[label]["pass2"] = {"key_range": key_range, "listed": listed,
                                   "pairs": scatter.pair_count(keys, n_keys, key_range)}
        for name, fn in calls.items():
            per_name = profile_kernels(fn, PROFILED)
            rec[label][name] = {
                "host_us": host_us(fn),
                "device_ms": sum(t for t, _ in per_name.values()) / PROFILED / 1e3,
                "kernels": {k: [t / PROFILED / 1e3, c / PROFILED]
                            for k, (t, c) in per_name.items()}}
    print(json.dumps({"scatter_time": rec}))
    return rec


if __name__ == "__main__":
    main()
