"""Design candidates of the traversal kernels, side by side on one GPU.

    python -m hare_tpu_torch.benchmarks.kernel_sweep [--kernels k1,b1,b2,b3]
        [--parent DIR] [--reps N]

Each candidate is a kernel's built source (``kernels/csrc/grid_shoot.cu``
K1, ``brute_shoot.cu`` B1, ``tree_shoot.cu`` B2, ``ropes_shoot.cu`` B3) with
a few statements replaced (``CANDIDATES``: lanes per ray G, threads per
block, one group per ray instead of the persistent launch, B2's stack in
the group's registers, K1's next cell's meta loaded before this cell's
test), or built with nvcc's default FMA contraction (``-fmad=true``); the
sources themselves stay as built.  With ``--parent``, the same kernel of
another checkout of the repository is one more candidate, built with that
checkout's flags and called through the parameters its own entry point
declares.  Each is compiled by its own ``nvcc -Xptxas -v`` (registers and
spills are printed), all at once, into a shared library loaded with ctypes.

The cases: K1 on the bench scene's grid, B2 on its octree and SAH KD tree,
B3 on its rope tree (bench scene of ``bench.py``: 82k triangles, 32,768
rays, the rays of each of 3 bounces of one grid trace), B1 on eval config 1
(the 12-triangle shoebox, 10,000 rays, each of 3 bounces of its own trace)
and on the bench scene's first bounce (the referee's shoot).
Every candidate is checked against the built kernel on each bounce's rays
(bit-equal, pops or steps included, where it is built with the same flags;
otherwise the rays that differ are counted) and timed on the device with
torch.profiler, in the order A B ... B A per bounce, so that every
candidate is measured before and after the others.  Prints one line per
case, candidate and bounce, then all of it as one JSON line.
"""

from __future__ import annotations

import argparse
import ast
import ctypes
import json
import re
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

from ..kernels import build
from .bench_scene import N_RAYS, bench_setup, bounce_rays, device_ms

__all__ = ["CANDIDATES", "FMA_FLAGS", "SPECS", "variant_source"]

# The built flags with nvcc's default contraction of a * b + c into FMAs.
FMA_FLAGS = tuple(f for f in build.NVCC_FLAGS if f != "-fmad=false")


class Spec(NamedTuple):
    source: str  # the file in kernels/csrc
    entry: str  # its C entry point
    tag: str  # the device kernel's name, as the profiler records it
    args: Tuple[str, ...]  # C names of what the wrapper's *_args function returns


SPECS = {
    "k1": Spec("grid_shoot.cu", "hare_grid_shoot", "grid_shoot_kernel",
               ("o", "d", "ex", "n", "cell_meta", "win_geom", "win_ids", "fparams", "iparams",
                "best_t", "best_tri")),
    "b1": Spec("brute_shoot.cu", "hare_brute_shoot", "brute_shoot_kernel",
               ("o", "d", "ex", "n", "tri_geom", "tri_meta", "n_tris", "min_t", "top_index",
                "mt", "best_t", "best_tri")),
    "b2": Spec("tree_shoot.cu", "hare_tree_shoot", "tree_shoot_kernel",
               ("o", "d", "ex", "n", "child_box", "child_info", "win_geom", "win_ids", "min_t",
                "iparams", "best_t", "best_tri", "pops", "err")),
    "b3": Spec("ropes_shoot.cu", "hare_ropes_shoot", "ropes_shoot_kernel",
               ("o", "d", "ex", "n", "node_tab", "split", "box", "leaf_win", "ropes", "win_geom",
                "win_ids", "fparams", "iparams", "best_t", "best_tri", "steps", "err")),
}


def _one_group_per_ray(kernel: str, smem: str) -> Tuple[str, str]:
    """As many blocks as the rays need, not as many as fit at once."""
    return (f"hare::persistent_blocks({kernel}, n, kGroup, kBlock, {smem})",
            "static_cast<int>((static_cast<long long>(n) * kGroup + kBlock - 1) / kBlock)")


# The statements of grid_shoot.cu the K1 candidates replace.
_K1_TEST = """      // ---- the group tests the cell's window rows together.
      if (n_wins > 0)
        hare::test_run_group<MT, kGroup>(ray, win_geom, win_ids, row0, n_wins, g.win, filter,
                                         lane, mask, best_t, best_tri);
"""
_K1_EXIT = "      if (off || !(t_enter <= best_t)) break;\n"

# B2's stack in the group's registers instead of shared memory: entry e on
# lane e % G, in register slot e / G, selected by unrolled compares; a pop
# is a shuffle from its lane, and each lane takes the pushed entry that
# lands on it.
_B2_REGISTER_STACK = (
    ("""  extern __shared__ int stacks[];
""", ""),
    ("""  int* st_node = stacks + group * p.stack;
  float* st_t = reinterpret_cast<float*>(stacks + (kBlock / kGroup) * p.stack) + group * p.stack;
""", """  int* st_node = nullptr;
  float* st_t = nullptr;
  (void)group;
"""),
    ("const size_t smem = static_cast<size_t>(kBlock / kGroup) * p.stack * (sizeof(int) + sizeof(float));",
     "const size_t smem = 0;"),
    ("""  if (lane == 0) {
    st_node[0] = p.pseudo_root;
    st_t[0] = 0.f;
  }
""", """  constexpr int kSlots = (kMaxStack + kGroup - 1) / kGroup;
  int reg_node[kSlots];
  float reg_t[kSlots];
  if (lane == 0) {
    reg_node[0] = p.pseudo_root;
    reg_t[0] = 0.f;
  }
"""),
    ("""    const int node = st_node[sp];
    const float t_node = st_t[sp];
""", """    int node = 0;
    float t_node = 0.f;
#pragma unroll
    for (int r = 0; r < kSlots; ++r)
      if (r == sp / kGroup) {
        node = reg_node[r];
        t_node = reg_t[r];
      }
    node = __shfl_sync(mask, node, sp % kGroup, kGroup);
    t_node = __shfl_sync(mask, t_node, sp % kGroup, kGroup);
"""),
    ("""    if (push) {
      st_node[sp + pos] = info.x;
      st_t[sp + pos] = tmin;
    }
""", """    {
      const int q = (lane - sp % kGroup + kGroup) % kGroup;  // the push place landing here
      int src = 0;
#pragma unroll
      for (int j = 0; j < K; ++j)
        src = __shfl_sync(mask, push ? pos : -1, j, kGroup) == q ? j : src;
      const int v_node = __shfl_sync(mask, info.x, src, kGroup);
      const float v_t = __shfl_sync(mask, tmin, src, kGroup);
      if (q < n_push) {
        const int slot = (sp + q) / kGroup;
#pragma unroll
        for (int r = 0; r < kSlots; ++r)
          if (r == slot) {
            reg_node[r] = v_node;
            reg_t[r] = v_t;
          }
      }
    }
"""),
)

# kernel -> ((label, (old, new) replacements applied in order, each old text
# occurring exactly once; nvcc flags, None for the built ones), ...); the
# first candidate of each is the built source.
CANDIDATES = {
    "k1": (
        ("G16 (built)", (), None),
        ("G8", (("constexpr int kGroup = 16;", "constexpr int kGroup = 8;"),), None),
        ("G32", (("constexpr int kGroup = 16;", "constexpr int kGroup = 32;"),), None),
        ("G16 block 256", (("constexpr int kBlock = 128;", "constexpr int kBlock = 256;"),), None),
        ("G16 one group per ray", (_one_group_per_ray("grid_shoot_kernel<MT>", "0"),), None),
        # This cell's test after the next cell's cell_meta load is issued.
        ("G16 prefetch", ((_K1_TEST, ""), (_K1_EXIT, _K1_TEST + _K1_EXIT)), None),
        ("G16 -fmad=true", (), FMA_FLAGS),
    ),
    "b1": (
        ("built", (), None),
        ("-fmad=true", (), FMA_FLAGS),
    ),
    "b2": (
        ("G8 (built)", (), None),
        ("G16", (("constexpr int kGroup = 8;", "constexpr int kGroup = 16;"),), None),
        ("G8 block 256", (("constexpr int kBlock = 128;", "constexpr int kBlock = 256;"),), None),
        ("G8 one group per ray", (_one_group_per_ray("tree_shoot_kernel<K, MT>", "smem"),), None),
        ("G8 register stack", _B2_REGISTER_STACK, None),
        ("G8 -fmad=true", (), FMA_FLAGS),
    ),
    "b3": (
        ("G16 (built)", (), None),
        ("G8", (("constexpr int kGroup = 16;", "constexpr int kGroup = 8;"),), None),
        ("G16 block 256", (("constexpr int kBlock = 128;", "constexpr int kBlock = 256;"),), None),
        ("G16 one group per ray", (_one_group_per_ray("ropes_shoot_kernel<MT>", "0"),), None),
        ("G16 -fmad=true", (), FMA_FLAGS),
    ),
}

_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float, "long": ctypes.c_longlong}


def variant_source(src: str, replacements) -> str:
    """``src`` with each ``(old, new)`` applied in order; raises unless
    every ``old`` occurs exactly once."""
    for old, new in replacements:
        if src.count(old) != 1:
            raise ValueError(f"the source holds {src.count(old)} copies of {old!r}")
        src = src.replace(old, new)
    return src


def _c_params(src: str, entry: str) -> List[Tuple[str, object]]:
    """``(name, ctypes type)`` of each parameter of C entry point ``entry``
    as the source ``src`` declares it."""
    m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src)
    if m is None:
        raise ValueError(f"no {entry} entry point in the source")
    out = []
    for decl in m.group(1).split(","):
        words = decl.split()
        name = words[-1].lstrip("*")
        if "*" in decl:
            out.append((name, ctypes.c_void_p))
        elif words[-2] in _C_TYPES:
            out.append((name, _C_TYPES[words[-2]]))
        else:
            raise ValueError(f"{entry}: unknown parameter type in {decl!r}")
    return out


def _nvcc_flags(checkout: Path) -> Tuple[str, ...]:
    """The ``NVCC_FLAGS`` another checkout's ``kernels/build.py`` builds
    with, read from its source (that package is not imported)."""
    tree = ast.parse((checkout / "hare_tpu_torch/kernels/build.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "NVCC_FLAGS" for t in node.targets):
            return tuple(ast.literal_eval(node.value))
    raise ValueError(f"{checkout}: no NVCC_FLAGS in kernels/build.py")


class Variant(NamedTuple):
    label: str
    text: str  # the source
    include: Path  # its headers' directory
    flags: Tuple[str, ...]


def _build(entry: str, variants: List[Variant], out_dir: Path, prefix: str):
    """Compile every variant into its own shared library, all nvcc
    processes at once; returns ``{label: (C function, C parameters, ptxas
    report)}``."""
    nvcc = build._nvcc()
    procs = []
    for k, v in enumerate(variants):
        src, lib = out_dir / f"{prefix}_{k}.cu", out_dir / f"{prefix}_{k}.so"
        src.write_text(v.text)
        cmd = [nvcc, *v.flags, "-Xptxas", "-v", "-I", str(v.include), "-shared", "-o", str(lib),
               str(src)]
        procs.append((v, lib, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    done = [(v, lib, cmd, *proc.communicate(), proc.returncode) for v, lib, cmd, proc in procs]
    out = {}
    for v, lib, cmd, _, err, rc in done:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}) for {v.label}:\n{' '.join(cmd)}\n{err}")
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        params = _c_params(v.text, entry)
        fn.argtypes = [t for _, t in params]
        fn.restype = ctypes.c_int
        # Registers and spills of each instance (watertight and MT, each K).
        report = [line.replace("ptxas info    :", "").strip() for line in err.splitlines()
                  if "registers" in line or "spill" in line]
        out[v.label] = (fn, params, report)
    return out


class Case(NamedTuple):
    name: str
    kernel: str  # a key of SPECS
    batches: list  # the rays of each bounce
    # (rays, best_t, best_tri, stats or None, err) -> the wrapper's *_args tuple
    args: Callable


def _cases(dev, kernels) -> List[Case]:
    import hare_tpu_torch as th
    from hare_tpu_torch.accel import brute, ropes, tree, voxel
    from hare_tpu_torch.mesh import shapes

    cases = []
    top, sp, rays, absorption = bench_setup(dev)
    bench = bounce_rays(sp, rays, absorption)
    if "k1" in kernels:
        cases.append(Case("K1 grid", "k1", bench,
                          lambda r, t, i, s, e: voxel.grid_shoot_args(r, sp.struct, t, i)))
    if "b1" in kernels:
        room = th.Topology.build(shapes.shoebox(4, 5, 3))
        sp1 = th.SpatialPartition(room, accel="brute", device=dev)
        c1 = th.Ray.make(torch.tensor((2.0, 2.5, 1.5), device=dev).expand(10_000, 3).contiguous(),
                         th.uniform_sphere(10_000, torch.Generator().manual_seed(0), device=dev))
        a1 = torch.full((room.n_polys,), absorption[0].item(), device=dev)
        cases.append(Case("B1 config 1", "b1", bounce_rays(sp1, c1, a1),
                          lambda r, t, i, s, e: brute.brute_shoot_args(sp1.scene, r, t, i)))
        # The referee's shoot: every bench ray of bounce 1 against every triangle.
        cases.append(Case("B1 bench referee", "b1", bench[:1],
                          lambda r, t, i, s, e: brute.brute_shoot_args(sp.scene, r, t, i)))
    if "b2" in kernels:
        for accel in ("octree", "kdtree"):
            st = th.SpatialPartition(top, accel=accel, device=dev).struct
            cases.append(Case(f"B2 {accel}", "b2", bench,
                              lambda r, t, i, s, e, st=st: tree.tree_shoot_args(r, st, t, i, s, e)))
    if "b3" in kernels:
        st = th.SpatialPartition(top, accel="kdtree_ropes", device=dev).struct
        cases.append(Case("B3 ropes", "b3", bench,
                          lambda r, t, i, s, e: ropes.ropes_shoot_args(r, st, t, i, s, e)))
    return cases


def _caller(fn, params, given):
    missing = [name for name, _ in params if name not in given]
    if missing:
        raise ValueError(f"the entry point takes {missing}, unknown here")
    conv = [given[name].data_ptr() if isinstance(given[name], torch.Tensor) else given[name]
            for name, _ in params]

    def call():
        rc = fn(*conv)
        if rc != 0:
            raise RuntimeError(f"CUDA error {rc}")

    return call


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", default="k1,b1,b2,b3",
                    help="comma-separated, of " + ", ".join(SPECS))
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout whose kernels are candidates too")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the sweep times the card: torch.cuda.is_available() is False")
    kernels = [k for k in args.kernels.split(",") if k]
    unknown = set(kernels) - set(SPECS)
    if unknown:
        raise ValueError(f"unknown kernels {sorted(unknown)}")

    dev = torch.device("cuda")
    build.library()
    rec: Dict[str, object] = {"device": torch.cuda.get_device_name(0), "n_rays": N_RAYS}
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        libs = {}
        for key in kernels:
            spec = SPECS[key]
            built = (build.CSRC / spec.source).read_text()
            variants = [Variant(label, variant_source(built, reps), build.CSRC,
                                build.NVCC_FLAGS if flags is None else flags)
                        for label, reps, flags in CANDIDATES[key]]
            if args.parent is not None:
                parent = args.parent / "hare_tpu_torch/kernels/csrc"
                variants.insert(0, Variant("parent", (parent / spec.source).read_text(), parent,
                                           _nvcc_flags(args.parent)))
            libs[key] = (_build(spec.entry, variants, Path(tmp), key), variants)
            for label, (_, _, report) in libs[key][0].items():
                print(f"sweep ptxas {key} {label}: " + " | ".join(report))

        stream = torch.cuda.current_stream().cuda_stream
        for case in _cases(dev, kernels):
            spec = SPECS[case.kernel]
            built_libs, variants = libs[case.kernel]
            c_rec = rec[case.name] = {
                v.label: {"ptxas": built_libs[v.label][2], "flags": " ".join(v.flags)}
                for v in variants}
            walks = case.kernel in ("b2", "b3")
            built = next(v for v in variants if v.label == CANDIDATES[case.kernel][0][0])
            for b, r in enumerate(case.batches, 1):
                n = r.origin.shape[0]
                outs, ref = {}, None
                for v in [built] + [v for v in variants if v is not built]:
                    fn, params, _ = built_libs[v.label]
                    t = torch.empty(n, dtype=torch.float32, device=dev)
                    i = torch.empty(n, dtype=torch.int32, device=dev)
                    s = torch.empty(n, dtype=torch.int32, device=dev) if walks else None
                    e = torch.zeros(1, dtype=torch.int32, device=dev)
                    given = dict(zip(spec.args, case.args(r, t, i, s, e)))
                    given.update(counter=torch.zeros(2, dtype=torch.int32, device=dev),
                                 stream=stream)
                    call = _caller(fn, params, given)
                    call()
                    torch.cuda.synchronize()
                    if int(e.item()):
                        raise RuntimeError(f"{case.name} {v.label}: error flag set on bounce {b}")
                    got = (t, i) if s is None else (t, i, s)
                    if ref is None:
                        ref = got
                    differ = torch.zeros(n, dtype=torch.bool, device=dev)
                    for x, y in zip(got, ref):
                        differ |= x.view(torch.int32) != y.view(torch.int32)
                    hit = torch.isfinite(ref[0])
                    both = hit & torch.isfinite(t)
                    dt = float((t - ref[0])[both].abs().max()) if bool(both.any()) else 0.0
                    if v.flags == built.flags and v.label != "parent" and bool(differ.any()):
                        raise AssertionError(f"{case.name} {v.label}: {int(differ.sum())} rays "
                                             f"differ from the built kernel on bounce {b}")
                    outs[v.label] = (call, int(differ.sum()),
                                     int((torch.isfinite(t) != hit).sum()), dt)
                order = [v.label for v in variants]
                times = {label: [] for label in order}
                for label in order + order[::-1]:
                    times[label].append(device_ms(outs[label][0], spec.tag, args.reps))
                stats = float(ref[2].double().mean()) if walks else None
                for label in order:
                    ms = sum(times[label]) / len(times[label])
                    _, differ, mask, dt = outs[label]
                    c_rec[label][f"bounce{b}"] = dict(ms=ms, ms_each=times[label],
                                                      rays_differ=differ, hit_mask_differs=mask,
                                                      max_abs_dt=dt)
                    print(f"sweep {case.name} bounce {b} {label}: {ms:.4f} ms on the device "
                          f"({', '.join(f'{x:.4f}' for x in times[label])}); rays differing from "
                          f"the built kernel {differ} (hit mask {mask}, max |dt| {dt:.3e})"
                          + (f"; {'steps' if case.kernel == 'b3' else 'pops'} a ray {stats:.2f}"
                             if walks else ""))
            nb = len(case.batches)
            for label in c_rec:
                c = c_rec[label]
                c["mean_ms"] = sum(c[f"bounce{b}"]["ms"] for b in range(1, nb + 1)) / nb
                print(f"sweep {case.name} {label}: mean of {nb} bounce(s) {c['mean_ms']:.4f} ms")
    print(json.dumps({"kernel_sweep": rec}))
    return rec


if __name__ == "__main__":
    main()
