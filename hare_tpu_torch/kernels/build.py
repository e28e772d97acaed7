"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

All ``csrc/*.cu`` files compile into ONE shared library with a plain C
interface.  Each source compiles in its own nvcc process, all started
together, and one more links the objects::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \\
         -Xcompiler -fPIC -c -o <obj> csrc/<source>.cu      # one per source
    nvcc -shared -o hare_tpu_torch/_build/libhare_kernels_<hash>.so <objs>

``-fmad=false``: nvcc would otherwise contract ``a * b + c`` into one fused
multiply-add, rounded once, where each kernel's plain version (and the JAX
package) rounds the product and the sum apart.  Without it the kernels'
triangle tests, slab tests and DDA steps differ from their plain versions
in the last bit, which flips equal-t ties and near-zero hits.  With it
every kernel rounds each operation as its plain version does.

The build runs at first use (a few seconds), and again whenever the hash of
the sources and flags changes.  Nothing here runs at import time, so the
package imports on machines with no CUDA toolkit.

Every launch goes through :func:`launch`, which counts it under
``launches.<C entry point>`` (``utils.tracing``); ``hare_scatter_plan`` and
``hare_grid_shoot_capacity``, which run on the host alone, count under
``calls.<C entry point>``.  A
build counts under ``kernels.builds`` in the span ``hare.kernels.build``,
the library's load in ``hare.kernels.load``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from ..utils.tracing import count, counters, span

__all__ = ["NVCC_FLAGS", "library", "launch"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# Every C entry point: argument types in order; each returns a cudaError_t.
_SIGNATURES = {
    "hare_grid_shoot": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "hare_grid_shoot_capacity": [_I, _P, _P],
    "hare_brute_shoot": [_P, _P, _P, _I, _P, _P, _I, _F, _I, _I, _P, _P, _P, _P],
    "hare_tree_shoot": [_P, _P, _P, _I, _P, _P, _P, _P, _F, _P, _P, _P, _P, _P, _P, _P],
    "hare_ropes_shoot": [_P, _P, _P, _I] + [_P] * 7 + [_P, _P, _P, _P, _P, _P, _P, _P],
    "hare_finalize_hits": [_P, _P, _P, _P, _P, _P, _I, _I] + [_P] * 9 + [_P],
    "hare_finalize_hits_bwd": [_P] * 12 + [_I] + [_P] * 5,
    "hare_scatter_add_ordered": [_P, _P, _LL, _I, _I, _I, _P, _LL, _P, _P],
    "hare_scatter_plan": [_LL, _I, _P, _P],
    "hare_energy_histogram": [_P, _P, _P, _LL, _I, _F, _I, _P, _LL, _P, _P],
    "hare_histogram_bwd": [_P, _P, _P, _P, _LL, _LL, _I, _F, _I, _P, _P, _P],
    "hare_bounce_step": [_P] * 20 + [_I, _F] + [_P] * 10 + [_P],
    "hare_bounce_step_bwd": [_P] * 18 + [_I, _F] + [_P] * 9 + [_P],
    "hare_column_sum": [_P, _LL, _I, _I, _P, _P, _P],
    "hare_gather_sum_f32": [_P, _LL, _I, _P, _I, _I, _P, _P, _P],
    "hare_gather_sum_i32": [_P, _LL, _I, _P, _I, _I, _P, _P, _P],
    "hare_gather_sum_i32_f32": [_P, _LL, _I, _P, _I, _I, _P, _P, _P],
}
# Entry points that launch nothing: they compute on the host.
_HOST_ONLY = ("hare_scatter_plan", "hare_grid_shoot_capacity")
# The counter each entry point's calls count under.
_COUNTER = {name: ("calls." if name in _HOST_ONLY else "launches.") + name
            for name in _SIGNATURES}

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _build() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libhare_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    with span("hare.kernels.build"):
        count("kernels.builds")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
            objs, procs = [], []
            for src in sorted(CSRC.glob("*.cu")):
                obj = os.path.join(tmpdir, src.stem + ".o")
                cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                objs.append(obj)
                procs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
            # Wait for every compile before raising, so none outlives the build.
            done = [(cmd, proc.communicate()[1], proc.returncode) for cmd, proc in procs]
            for cmd, err, rc in done:
                if rc != 0:
                    raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{err}")
            tmp = os.path.join(tmpdir, "lib.so")
            cmd = [nvcc, "-shared", "-o", tmp, *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call.  Raises where there
    is no CUDA device or no nvcc — never falls back."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            if not torch.cuda.is_available():
                raise RuntimeError("the CUDA kernels need a CUDA device")
            path = _build()
            with span("hare.kernels.load"):
                lib = ctypes.CDLL(str(path))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                lib.hare_error_string.argtypes = [ctypes.c_int]
                lib.hare_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(name: str, *args) -> None:
    """Call C entry point ``name`` on the current CUDA stream, counted under
    ``launches.<name>``; raise if the launch reports an error.  Tensor
    arguments pass as their data pointers.
    """
    lib = library()
    counters[_COUNTER[name]] += 1
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    # The current device's current stream as a raw handle: what
    # torch.cuda.current_stream().cuda_stream gives, without building the
    # Stream object (microseconds a call, on a path the host bounds).
    stream = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
    rc = getattr(lib, name)(*conv, stream)
    if rc != 0:
        msg = lib.hare_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
