"""The Pallas feasibility probes of ``benchmarks/pallas_probe.py``, on a GPU.

On the TPU the probes asked how large a table one kernel can hold in VMEM
and how fast it gathers rows from it, at the bench grid's table shapes.  On
an NVIDIA GPU the same two kernels become:

- P1 :func:`column_sum`, the column sum of ``probe_vmem``: it streams the
  table, so the question becomes how fast warm repeated calls read as the
  table outgrows the 50 MB L2;
- P2/P3 :func:`gather_sum`, the wrapped row-gather loop of ``probe_gather``
  and ``probe_meta_gather`` (and of ``r4_dyngather_probe.probe``, P4): ns per
  gathered row, from L2 or from HBM.

Both wrappers launch ``kernels/csrc/gather_probe.cu`` for CUDA tensors and
run their plain PyTorch versions only for CPU tensors; any other device
raises.  The input builders make the JAX probes' arrays with NumPy, with the
same generators and calls, so the arrays are bit-equal.  The probes time the
card with CUDA events and raise where there is none; unlike the JAX
``probe_vmem``, nothing here catches a failed build or launch.

    python -m hare_tpu_torch.benchmarks.pallas_probe    # on a GPU host
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..accel.common import check_device
from ..kernels import build

__all__ = [
    "VMEM_SWEEP_MB",
    "column_sum",
    "column_sum_plain",
    "gather_inputs",
    "gather_sum",
    "gather_sum_plain",
    "meta_gather_inputs",
    "probe_gather",
    "probe_meta_gather",
    "probe_vmem",
    "seconds_per_call",
    "sums_agree",
    "vmem_table",
]

# The table sizes of the JAX probe's sweep (pallas_probe.py:118), in MB.
VMEM_SWEEP_MB = (8, 16, 32, 64, 96, 120)
# Pass-1 blocks of the column sum: 4 on each of an H100's 132 SMs.
COLUMN_BANDS = 528
# The column-sum kernel reads 16-byte float4 lanes, 512 threads a block.
MAX_COLUMNS = 4 * 512
# (table dtype, sum dtype) -> the C entry point of that instantiation.
_GATHER_ENTRIES = {
    (torch.float32, torch.float32): "hare_gather_sum_f32",
    (torch.int32, torch.int32): "hare_gather_sum_i32",
    (torch.int32, torch.float32): "hare_gather_sum_i32_f32",
}
# Kernel, plain version and the JAX kernel add the same float32 terms in
# different orders, and rounding makes the results differ: by ~1e-8 of
# sum |terms| at probe_gather's shape (the plain version against a float64
# sum).  The bound leaves 100x room and stays far below the size of any one
# term.  Integer sums (int32, or small integers in float32) agree exactly.
SUM_RTOL, SUM_ATOL_PER_ABS = 1e-5, 1e-6


def sums_agree(got: torch.Tensor, want: torch.Tensor, abs_terms: torch.Tensor) -> bool:
    """``|got - want| <= SUM_RTOL |want| + SUM_ATOL_PER_ABS * abs_terms``
    everywhere, where ``abs_terms`` is the sum of the terms' magnitudes."""
    err = (got.double() - want.double()).abs()
    bound = SUM_RTOL * want.double().abs() + SUM_ATOL_PER_ABS * abs_terms.double()
    return got.shape == want.shape and bool((err <= bound).all())


def _check_aligned(t: torch.Tensor) -> None:
    if t.data_ptr() % 16:
        raise ValueError("the kernel reads 16-byte vectors: the table must be 16-byte aligned")


# ---------------------------------------------------------------- P1
def column_sum(x: torch.Tensor) -> torch.Tensor:
    """P1: the ``(1, C)`` column sums of an ``(R, C)`` float32 table.

    CUDA tensors launch ``hare_column_sum`` (``C`` a multiple of 4, at most
    :data:`MAX_COLUMNS`); CPU tensors take :func:`column_sum_plain`.
    """
    if x.dim() != 2 or x.dtype != torch.float32:
        raise TypeError(f"x must be a 2-D float32 table; got {x.dtype} {tuple(x.shape)}")
    rows, cols = x.shape
    if cols == 0 or cols % 4 or cols > MAX_COLUMNS:
        raise ValueError(f"x needs a multiple of 4 columns, 4 to {MAX_COLUMNS}; got {cols}")
    if check_device(x) == "cpu":
        return column_sum_plain(x)
    x = x.contiguous()
    _check_aligned(x)
    bands = max(1, min(COLUMN_BANDS, rows // 64))
    partial = torch.empty(bands, cols, dtype=torch.float32, device=x.device)
    out = torch.empty(1, cols, dtype=torch.float32, device=x.device)
    column_sum.launches += 1
    build.launch("hare_column_sum", x, rows, cols, bands, partial, out)
    return out


column_sum.launches = 0


def column_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of P1: ``x.sum(0, keepdim=True)``."""
    return x.sum(0, keepdim=True)


# ---------------------------------------------------------------- P2-P4
def _gather_args(tab, idx, iters, out_dtype):
    out_dtype = tab.dtype if out_dtype is None else out_dtype
    entry = _GATHER_ENTRIES.get((tab.dtype, out_dtype))
    if entry is None:
        raise TypeError(
            f"no gather_sum for a {tab.dtype} table summed in {out_dtype}; "
            f"supported: {sorted((str(a), str(b)) for a, b in _GATHER_ENTRIES)}"
        )
    if tab.dim() != 2 or idx.dim() != 1 or idx.dtype != torch.int32:
        raise TypeError("tab must be 2-D and idx a 1-D int32 tensor")
    if not 0 < tab.shape[0] < 2**31 or idx.shape[0] >= 2**31 or not 0 <= iters < 2**31:
        raise ValueError(
            f"need 0 < table rows < 2^31, fewer than 2^31 indices and 0 <= iters "
            f"< 2^31; got {tab.shape[0]}, {idx.shape[0]}, {iters}"
        )
    return entry, out_dtype


def gather_sum(
    tab: torch.Tensor, idx: torch.Tensor, iters: int,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """P2-P4: ``o[r] = sum_{i < iters} sum_j tab[(idx[r] + i) mod n, j]``.

    ``tab`` (n, B) float32 or int32, ``idx`` (R,) int32; the sum is taken in
    ``out_dtype`` (default: the table's), and int32 sums wrap as JAX's do.
    CUDA tensors launch the kernel of that (table, sum) type pair; CPU
    tensors take :func:`gather_sum_plain`.
    """
    entry, out_dtype = _gather_args(tab, idx, iters, out_dtype)
    if check_device(tab, idx) == "cpu":
        return gather_sum_plain(tab, idx, iters, out_dtype)
    tab, idx = tab.contiguous(), idx.contiguous()
    _check_aligned(tab)
    out = torch.empty(idx.shape[0], dtype=out_dtype, device=tab.device)
    gather_sum.launches += 1
    build.launch(entry, tab, tab.shape[0], tab.shape[1], idx, idx.shape[0], iters, out)
    return out


gather_sum.launches = 0


def gather_sum_plain(
    tab: torch.Tensor, idx: torch.Tensor, iters: int,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain version of P2-P4: one ``index_select`` of the wrapped rows per
    step, each row summed, then added to the running sum, as the JAX kernels
    do.  int32 sums run exactly in int64 and wrap to int32 once at the end,
    which is what int32 adds that wrap give."""
    _, out_dtype = _gather_args(tab, idx, iters, out_dtype)
    wide = torch.int64 if out_dtype == torch.int32 else torch.float32
    rows = idx.to(torch.int64)
    acc = torch.zeros(idx.shape[0], dtype=wide, device=tab.device)
    for i in range(iters):
        acc = acc + tab.index_select(0, (rows + i) % tab.shape[0]).to(wide).sum(1)
    if out_dtype == torch.int32:
        acc = ((acc + 2**31) % 2**32 - 2**31).to(torch.int32)
    return acc


# ---------------------------------------------------------------- inputs
def vmem_table(mb: float) -> np.ndarray:
    """``probe_vmem``'s table: ``int(mb * 1e6) // 768`` rows of 192 float32 ones."""
    return np.ones((int(mb * 1e6) // (192 * 4), 192), np.float32)


def gather_inputs(n_rows: int = 23793, R: int = 1024) -> Tuple[np.ndarray, np.ndarray]:
    """``probe_gather``'s window-row table ``(n_rows, 192)`` f32 and ``(R,)`` indices."""
    table = np.random.default_rng(0).normal(size=(n_rows, 192)).astype(np.float32)
    idx = np.random.default_rng(1).integers(0, n_rows, size=(R,)).astype(np.int32)
    return table, idx


def meta_gather_inputs(
    n_cells: int = 110592, R: int = 32768
) -> Tuple[np.ndarray, np.ndarray]:
    """``probe_meta_gather``'s cell_meta table ``(n_cells, 2)`` int32 and ``(R,)`` indices."""
    table = np.random.default_rng(0).integers(0, 2**20, size=(n_cells, 2)).astype(np.int32)
    idx = np.random.default_rng(1).integers(0, n_cells, size=(R,)).astype(np.int32)
    return table, idx


# ---------------------------------------------------------------- probes
def seconds_per_call(fn: Callable[[], object], device, reps: int = 20) -> float:
    """Mean seconds per call of ``fn()`` over ``reps`` calls, by CUDA events
    after one warm-up call.  Raises unless ``device`` is a CUDA device."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"the probes time the card with CUDA events; {device} is no CUDA device")
    with torch.cuda.device(device):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps / 1e3


def probe_vmem(mb: float, device="cuda") -> bool:
    """P1: column-sum a ``vmem_table(mb)`` on ``device``; ``True`` once done."""
    x = torch.from_numpy(vmem_table(mb)).to(device)
    float(column_sum(x).sum())  # waits for the device
    return True


def probe_gather(
    n_rows: int = 23793, R: int = 1024, iters: int = 50, device="cuda"
) -> Tuple[float, float]:
    """P2: ``(ms per call, ns per gathered row)`` of ``iters`` wrapped gathers
    of ``R`` 192-float rows from an ``(n_rows, 192)`` table."""
    table, idx = (torch.from_numpy(a).to(device) for a in gather_inputs(n_rows, R))
    dt = seconds_per_call(lambda: gather_sum(table, idx, iters), device)
    return dt * 1e3, dt / (iters * R) * 1e9


def probe_meta_gather(
    n_cells: int = 110592, R: int = 32768, iters: int = 50, device="cuda"
) -> Tuple[float, float]:
    """P3: ``(ms per call, ns per gathered row)`` of ``iters`` wrapped gathers
    of ``R`` 2-int32 rows from a cell_meta-shaped ``(n_cells, 2)`` table."""
    table, idx = (torch.from_numpy(a).to(device) for a in meta_gather_inputs(n_cells, R))
    dt = seconds_per_call(lambda: gather_sum(table, idx, iters), device)
    return dt * 1e3, dt / (iters * R) * 1e9


if __name__ == "__main__":
    print("devices:", [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())])
    for mb in VMEM_SWEEP_MB:
        print(f"VMEM probe {mb} MB:", probe_vmem(mb), flush=True)
    ms, ns = probe_gather()
    print(f"win-row gather (1024 rows/step, 23793x192 table): {ms:.3f} ms/call, {ns:.2f} ns/row", flush=True)
    ms, ns = probe_meta_gather()
    print(f"cell_meta gather (32768 lanes, 110592x2 table): {ms:.3f} ms/call, {ns:.2f} ns/lane", flush=True)
