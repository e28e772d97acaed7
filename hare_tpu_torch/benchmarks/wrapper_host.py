"""Host cost of one K1, K2 and K4 call through their wrappers, in this
checkout or another.

    python hare_tpu_torch/benchmarks/wrapper_host.py [--tree DIR] [--reps N]

Imports ``hare_tpu_torch`` from the checkout ``DIR`` (default: the one that
holds this file), builds the bench scene's grid (``bench.py``: 82k
triangles, ``domain=48``) on the card and calls ``voxel.grid_shoot`` (K1)
and ``common.finalize_hits`` (K2) on a 1-ray batch, and where the
checkout has K4, on that ray's bounce step: ``bounce.bounce_kernel`` (K4),
``bounce.fused_bounce_step`` (the autograd Function around it, no
gradient), ``bounce.bounce_bwd_kernel`` (K4's backward, the energy chain)
and ``bounce.bounce_step`` (the torch ops K4 replaced, enqueued on the
card): wall microseconds per
call, the median over ``BLOCKS`` blocks of ``N / BLOCKS`` calls each (a
block that other work on the host slowed counts once), the card
synchronised before and after each block, the calls' blocks in turns.  The
kernel of one ray takes a few microseconds, less than its launch, so the
time is the wrapper's own: its checks, its allocations, the ctypes call
and the launch.  Prints one JSON line.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

BLOCKS = 10


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[2])
    ap.add_argument("--reps", type=int, default=2000)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.tree.resolve()))
    import torch

    import hare_tpu_torch as th
    from hare_tpu_torch.accel import common, voxel
    from hare_tpu_torch.mesh import shapes

    if not torch.cuda.is_available():
        raise RuntimeError("the wrappers' host cost is timed on the card")
    dev = torch.device("cuda")
    faces = shapes.shoebox(20.0, 20.0, 20.0) + shapes.icosphere(
        6, radius=6.0, center=(10.0, 10.0, 10.0))
    sp = th.SpatialPartition(th.Topology.build(faces), accel="grid", domain=48, device=dev)
    one = th.Ray.make(torch.tensor([[10.0, 10.0, 16.5]], device=dev),
                      torch.tensor([[0.0, 0.0, 1.0]], device=dev))
    best_t, best_tri = voxel.grid_shoot(one, sp.struct)
    calls = {"k1": lambda: voxel.grid_shoot(one, sp.struct),
             "k2": lambda: common.finalize_hits(sp.scene, one, best_t, best_tri)}
    from hare_tpu_torch.trace import bounce

    if hasattr(bounce, "bounce_kernel"):
        hr = common.finalize_hits(sp.scene, one, best_t, best_tri)
        state = bounce.BounceState(one.origin, one.direction, one.exclude_poly,
                                   torch.ones(1, device=dev), torch.zeros(1, device=dev),
                                   torch.ones(1, dtype=torch.bool, device=dev))
        a = torch.full((sp.scene.n_polys,), 0.3, device=dev)
        g = torch.ones(1, device=dev)
        cot = (None, None, g, None, g, None, None)
        want = tuple(k in ("energy", "absorption") for k in bounce.GRADS)
        calls.update(
            k4=lambda: bounce.bounce_kernel(state, hr, a),
            k4_function=lambda: bounce.fused_bounce_step(state, hr, a, tri_meta=sp.scene.tri_meta),
            k4_bwd=lambda: bounce.bounce_bwd_kernel(state, hr, a, None, None, cot, want),
            glue=lambda: bounce.bounce_step(state, hr, a))
    rec = {"tree": str(args.tree), "package": str(Path(th.__file__).parent), "reps": args.reps,
           "device": torch.cuda.get_device_name(0)}
    per_block = args.reps // BLOCKS
    us = {key: [] for key in calls}
    for fn in calls.values():
        fn()
    for _ in range(BLOCKS):
        for key, fn in calls.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(per_block):
                fn()
            torch.cuda.synchronize()
            us[key].append((time.perf_counter() - t) / per_block * 1e6)
    for key, blocks in us.items():
        rec[f"{key}_host_us_per_call"] = statistics.median(blocks)
        rec[f"{key}_host_us_blocks"] = blocks
    print(json.dumps({"wrapper_host": rec}))
    return rec


if __name__ == "__main__":
    main()
