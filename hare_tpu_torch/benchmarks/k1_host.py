"""Host cost of one K1 call through its wrapper, in this checkout or another.

    python hare_tpu_torch/benchmarks/k1_host.py [--tree DIR] [--reps N]

Imports ``hare_tpu_torch`` from the checkout ``DIR`` (default: the one that
holds this file), builds the bench scene's grid (``bench.py``: 82k
triangles, ``domain=48``) on the card and calls ``voxel.grid_shoot`` on a
1-ray batch: wall microseconds per call over ``N`` calls, the card
synchronised before and after.  The kernel of one ray takes a few
microseconds, less than its launch, so the time is the wrapper's own: its
checks, its allocations, the ctypes call and the launch.  Prints one JSON
line.
"""

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[2])
    ap.add_argument("--reps", type=int, default=2000)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.tree.resolve()))
    import torch

    import hare_tpu_torch as th
    from hare_tpu_torch.accel import voxel
    from hare_tpu_torch.mesh import shapes

    if not torch.cuda.is_available():
        raise RuntimeError("the wrapper's host cost is timed on the card")
    dev = torch.device("cuda")
    faces = shapes.shoebox(20.0, 20.0, 20.0) + shapes.icosphere(
        6, radius=6.0, center=(10.0, 10.0, 10.0))
    sp = th.SpatialPartition(th.Topology.build(faces), accel="grid", domain=48, device=dev)
    one = th.Ray.make(torch.tensor([[10.0, 10.0, 16.5]], device=dev),
                      torch.tensor([[0.0, 0.0, 1.0]], device=dev))
    voxel.grid_shoot(one, sp.struct)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(args.reps):
        voxel.grid_shoot(one, sp.struct)
    torch.cuda.synchronize()
    us = (time.perf_counter() - t) / args.reps * 1e6
    rec = {"tree": str(args.tree), "package": str(Path(th.__file__).parent), "reps": args.reps,
           "host_us_per_call": us}
    print(json.dumps({"k1_host": rec}))
    return rec


if __name__ == "__main__":
    main()
