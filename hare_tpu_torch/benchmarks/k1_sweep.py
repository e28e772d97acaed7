"""K1 ``grid_shoot`` design candidates, side by side on one GPU.

    python -m hare_tpu_torch.benchmarks.k1_sweep [--parent DIR] [--reps N]

Each candidate is ``kernels/csrc/grid_shoot.cu`` with a few lines of it
replaced (``CANDIDATES``: lanes per ray G, threads per block, one group per
ray instead of the persistent launch, the next cell's meta loaded before
this cell's test); the source itself stays as built.  With ``--parent``,
the ``grid_shoot.cu`` of another checkout of the repository is one more
candidate, called through the parameters its own entry point declares.
Each is compiled by its own ``nvcc -Xptxas -v`` (registers and spills are
printed), all at once, into a shared library loaded with ctypes.

On the bench scene of ``bench.py`` (82k triangles, grid ``domain=48``,
32,768 rays, 3 bounces) it captures the rays of every bounce from one
``trace_rays`` run, checks every candidate against the built K1 on each
bounce's rays (the same hit mask, t within the kernel-vs-plain tolerance,
and the rays that differ at all counted), and times each on the device
with torch.profiler, in the order A B ... B A per bounce, so that every
candidate is measured before and after the others.  Prints one line per
candidate and bounce, then all of it as one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from .bench_scene import N_RAYS, bench_setup, bounce_rays, device_ms

__all__ = ["CANDIDATES", "variant_source"]

# The statements of grid_shoot.cu the candidates replace.
_GROUP = "constexpr int kGroup = 16;"
_BLOCK = "constexpr int kBlock = 128;"
_TEST = """      // ---- the group tests the cell's window rows together.
      if (n_wins > 0)
        hare::test_run_group<MT, kGroup>(ray, win_geom, win_ids, row0, n_wins, g.win, filter,
                                         lane, mask, best_t, best_tri);
"""
_EXIT = "      if (off || !(t_enter <= best_t)) break;\n"

# (label, (old, new) replacements applied in order; each old text must occur
# exactly once).
CANDIDATES = (
    ("G16 (built)", ()),
    ("G8", ((_GROUP, "constexpr int kGroup = 8;"),)),
    ("G32", ((_GROUP, "constexpr int kGroup = 32;"),)),
    ("G16 block 256", ((_BLOCK, "constexpr int kBlock = 256;"),)),
    # As many blocks as rays need, not as many as fit at once.
    ("G16 one group per ray", tuple(
        (f"min(ray_blocks, resident_blocks<{mt}>())", "ray_blocks") for mt in ("true", "false"))),
    # This cell's test after the next cell's cell_meta load is issued.
    ("G16 prefetch", ((_TEST, ""), (_EXIT, _TEST + _EXIT))),
)

# C parameter names of hare_grid_shoot -> what this sweep passes; the
# arguments voxel.grid_shoot_args gives, in its order, come first.
_ARG_NAMES = ("o", "d", "ex", "n", "cell_meta", "win_geom", "win_ids", "fparams", "iparams",
              "best_t", "best_tri")


def variant_source(src: str, replacements) -> str:
    """``src`` with each ``(old, new)`` applied in order; raises unless
    every ``old`` occurs exactly once."""
    for old, new in replacements:
        if src.count(old) != 1:
            raise ValueError(f"grid_shoot.cu holds {src.count(old)} copies of {old!r}")
        src = src.replace(old, new)
    return src


def _c_params(src: str) -> List[Tuple[str, object]]:
    """``(name, ctypes type)`` of each parameter of ``hare_grid_shoot`` as
    the source ``src`` declares it."""
    m = re.search(r'extern "C" int hare_grid_shoot\(([^)]*)\)', src)
    if m is None:
        raise ValueError("no hare_grid_shoot entry point in the source")
    out = []
    for decl in m.group(1).split(","):
        name = decl.split()[-1].lstrip("*")
        if "*" in decl:
            out.append((name, ctypes.c_void_p))
        elif decl.split()[-2] == "int":
            out.append((name, ctypes.c_int))
        else:
            raise ValueError(f"hare_grid_shoot: unknown parameter type in {decl!r}")
    return out


def _build(variants: List[Tuple[str, str, Path]], out_dir: Path):
    """Compile every ``(label, source text, include dir)`` into its own
    shared library, all nvcc processes at once; returns ``{label: (CDLL,
    C parameters, ptxas report)}``."""
    from hare_tpu_torch.kernels import build

    nvcc = build._nvcc()
    procs = []
    for k, (label, text, include) in enumerate(variants):
        src, lib = out_dir / f"k1_{k}.cu", out_dir / f"k1_{k}.so"
        src.write_text(text)
        cmd = [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(include), "-shared",
               "-o", str(lib), str(src)]
        procs.append((label, text, lib, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    done = [(label, text, lib, cmd, *proc.communicate(), proc.returncode)
            for label, text, lib, cmd, proc in procs]
    out = {}
    for label, text, lib, cmd, _, err, rc in done:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}) for {label}:\n{' '.join(cmd)}\n{err}")
        so = ctypes.CDLL(str(lib))
        params = _c_params(text)
        so.hare_grid_shoot.argtypes = [t for _, t in params]
        so.hare_grid_shoot.restype = ctypes.c_int
        # Registers and spills of the watertight, then the MT instance.
        report = [line.replace("ptxas info    :", "").strip() for line in err.splitlines()
                  if "registers" in line or "spill" in line]
        out[label] = (so, params, report)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout whose grid_shoot.cu is a candidate")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the sweep times the card: torch.cuda.is_available() is False")

    from hare_tpu_torch.accel import voxel
    from hare_tpu_torch.kernels import build

    dev = torch.device("cuda")
    csrc = Path(build.CSRC)
    built = (csrc / "grid_shoot.cu").read_text()
    variants = [(label, variant_source(built, reps), csrc) for label, reps in CANDIDATES]
    if args.parent is not None:
        parent = args.parent / "hare_tpu_torch/kernels/csrc"
        variants.insert(0, ("parent", (parent / "grid_shoot.cu").read_text(), parent))
    build.library()
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        libs = _build(variants, Path(tmp))
        for label, (_, _, report) in libs.items():
            print(f"k1 sweep ptxas {label}: " + " | ".join(report))

        _, sp, rays, absorption = bench_setup(dev)
        grid = sp.struct
        batches = bounce_rays(sp, rays, absorption)
        stream = torch.cuda.current_stream().cuda_stream
        rec: Dict[str, object] = {
            "device": torch.cuda.get_device_name(0), "n_rays": N_RAYS,
            "candidates": {label: {"ptxas": report} for label, (_, _, report) in libs.items()}}
        order = [label for label, *_ in variants]
        for b, r in enumerate(batches, 1):
            ref_t, ref_tri = voxel.grid_shoot(r, grid)
            outs = {}
            for label in order:
                so, params, _ = libs[label]
                best_t = torch.empty_like(ref_t)
                best_tri = torch.empty_like(ref_tri)
                given = dict(zip(_ARG_NAMES, voxel.grid_shoot_args(r, grid, best_t, best_tri)))
                given["counter"] = torch.zeros(2, dtype=torch.int32, device=dev)
                given["stream"] = stream
                missing = [name for name, _ in params if name not in given]
                if missing:
                    raise ValueError(f"{label}: hare_grid_shoot takes {missing}, unknown here")
                conv = [given[name].data_ptr() if isinstance(given[name], torch.Tensor)
                        else given[name] for name, _ in params]

                def call(so=so, conv=conv):
                    rc = so.hare_grid_shoot(*conv)
                    if rc != 0:
                        raise RuntimeError(f"hare_grid_shoot: CUDA error {rc}")

                call()
                torch.cuda.synchronize()
                differ = int(((best_t != ref_t) | (best_tri != ref_tri)).sum())
                hit = torch.isfinite(ref_t)
                if not torch.equal(torch.isfinite(best_t), hit):
                    raise AssertionError(f"{label}: hit mask differs from the built K1 on bounce {b}")
                dt = float((best_t - ref_t)[hit].abs().max()) if bool(hit.any()) else 0.0
                if dt > 1e-5 + 1e-5 * float(ref_t[hit].abs().max()):
                    raise AssertionError(f"{label}: t differs by {dt} on bounce {b}")
                outs[label] = (call, differ, dt)
            times = {label: [] for label in order}
            for label in order + order[::-1]:
                times[label].append(device_ms(outs[label][0], "grid_shoot_kernel", args.reps))
            for label in order:
                ms = sum(times[label]) / len(times[label])
                rec["candidates"][label][f"bounce{b}"] = dict(
                    ms=ms, ms_each=times[label], rays_differ=outs[label][1],
                    max_abs_dt=outs[label][2])
                print(f"k1 sweep bounce {b} {label}: {ms:.4f} ms on the device "
                      f"({', '.join(f'{t:.4f}' for t in times[label])}); rays differing from the "
                      f"built K1 {outs[label][1]}, max |dt| {outs[label][2]:.3e}")
        for label in order:
            c = rec["candidates"][label]
            c["mean_ms"] = sum(c[f"bounce{b}"]["ms"] for b in range(1, len(batches) + 1)) / len(batches)
            print(f"k1 sweep {label}: mean of {len(batches)} bounces {c['mean_ms']:.4f} ms")
    print(json.dumps({"k1_sweep": rec}))
    return rec


if __name__ == "__main__":
    main()
