#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once and print its result line.

    python3 raybench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  ``--trace 0`` measures the cell's end-to-end
metrics over ``--seconds`` of closed-loop steps (under the profiler's device
activity alone where one of them reads the device's time, as
``metrics/step_device_ms.py`` does); ``--trace 1`` profiles
the steps and reads its per-layer metrics.  Either way the window's last
step is checked against the plain reference once the window has closed,
and the last line of standard output is one JSON object.  Without as many
CUDA devices as the cell asks for it exits with 2 and prints no result.

``--control <seed,seed,...>`` instead prints, for each seed, the numbers
the check compares for the program and for the control (the reference in
bfloat16 in the program's place), all in one process: the readings the
limits in ``limits/<cell>.json`` are set from.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# Build and kernel caches live at fixed paths inside the checkout.
CACHE = ROOT / ".raybench_cache"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default="")
    args = p.parse_args(argv)
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    sys.path.insert(0, str(ROOT))
    from raybench import cells, harness

    t_start = harness.process_start()
    import torch

    cell = cells.resolve(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    if args.control:
        seeds = [int(x) for x in args.control.split(",")]
        rows = harness.control_run(cell, seeds, "cuda")
        print(json.dumps({"workload": cell.name, "readings": rows}))
        return 0
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules that must not load were loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
