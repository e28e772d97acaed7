"""Cost of one ``scatter_add_ordered`` call, in this checkout or another.

    python hare_tpu_torch/benchmarks/scatter_time.py [--tree DIR]

Imports ``hare_tpu_torch`` from the checkout ``DIR`` (default: the one that
holds this file), builds the bench scene (``bench.py``: 82k triangles, grid
``domain=48``, 32,768 rays) on the card, shoots the first bounce and takes
the two scatters of the bench gradient paths on its rays: A3's corner
cotangents onto the vertices (98,304 x 3 values) and seeded values onto
the polygons' absorption keys (32,768 values into 81,932 keys); eval
config 3's absorption keys (1M rays' first polygons in the concert hall,
octree); and eval config 4's A3 corner cotangents of its first bounce
(98,304 x 3 values into 327,698 vertex keys, SAH KD tree).  For each, and
for one ``index_add_`` on the same inputs (its yardstick):

- host microseconds a call: wall time over ``REPS`` calls, the card
  synchronised before and after (the card runs each call faster than the
  host issues it, so this is the wrapper's own cost);
- device milliseconds a call: every kernel the call launches (a sort's
  too, where the checkout's wrapper sorts), by torch.profiler, with each
  kernel's milliseconds and launches a call.

Run it on this tree and a parent checkout in turns.  Prints one JSON line.
"""

import argparse
import json
import sys
import time
from pathlib import Path

SEED = 7
# Eval config 3 (benchmarks/configs.py): rays and source point.
HALL_RAYS, HALL_ORIGIN = 1_000_000, (15.0, 24.0, 8.0)
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
             + (scene4.vertices.shape[0],)}
    rec = {"tree": str(args.tree), "package": str(Path(th.__file__).parent),
           "device": torch.cuda.get_device_name(0), "reps": REPS}
    for label, (keys, values, n_keys) in cases.items():
        lib_out, lib_idx = torch.zeros((n_keys,) + tuple(values.shape[1:]), device=dev), keys.long()
        calls = {"scatter_add_ordered": lambda: scatter.scatter_add_ordered(keys, values, n_keys),
                 "index_add_": lambda: lib_out.index_add_(0, lib_idx, values)}
        rec[label] = {"values": keys.numel(), "cols": 1 if values.dim() == 1 else values.shape[1],
                      "keys": n_keys, "keys_used": int(torch.unique(keys).numel())}
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
