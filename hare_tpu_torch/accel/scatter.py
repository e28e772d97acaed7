"""Fixed-order scatter-add, and the gather whose gradient it is.

The JAX package's gradients sum cotangents by an integer key wherever its
forward gathered: the vertex cotangents of the finalize backward onto the
welded vertices (the transpose of ``vertices[iv[:, k]]``,
``hare_tpu/accel/common.py:390``) and the absorption gradient onto the
polygons (the transpose of ``absorption[pid]``,
``hare_tpu/trace/bounce.py:194``).  On CUDA, PyTorch's own scatter-add is a
float atomic, whose order, and so whose last bits, change from run to run.
:func:`scatter_add_ordered` sums in an order fixed by the keys alone, on the
card (``kernels/csrc/scatter.cu``) as on the CPU, so two runs give the same
bits and the card gives the CPU's bits.

The order: a stable sort of the keys makes each key's values one run of
sorted positions, in increasing index; the positions are cut into segments
of ``SEGMENT``; each run's part in a segment is summed in index order from
zero, and a run's parts are added in segment order.  A run inside one
segment is summed exactly as ``index_add_`` sums it.  Cutting the runs
keeps each chain of dependent adds on the card at most ``SEGMENT`` long:
one chain a key made a wall hit by 147k rays cost milliseconds.
"""

from __future__ import annotations

import torch

from ..kernels import build
from .common import check_device

__all__ = ["gather_rows", "scatter_add_ordered", "scatter_add_plain"]

# Value widths the kernel takes: (M,) or (M, 3).
SCATTER_COLS = (1, 3)
# Sorted positions summed apart before a run's parts are added; the kernel
# takes it as an argument.
SEGMENT = 1024


def scatter_add_plain(keys: torch.Tensor, values: torch.Tensor, n_keys: int) -> torch.Tensor:
    """Plain version, in the kernel's order: a stable sort of the keys, each
    segment of ``SEGMENT`` sorted positions summed by key with
    ``index_add_`` into zeros (on the CPU, in index order), the segments'
    sums added in order.  Keys outside ``[0, n_keys)`` raise."""
    order = torch.sort(keys, stable=True)[1]
    k, v = keys[order].long(), values[order]
    out = torch.zeros((n_keys,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    for s in range(0, k.shape[0], SEGMENT):
        out += torch.zeros_like(out).index_add_(0, k[s:s + SEGMENT], v[s:s + SEGMENT])
    return out


def scatter_add_ordered(keys: torch.Tensor, values: torch.Tensor, n_keys: int) -> torch.Tensor:
    """``out[k] = sum of values[i] over keys[i] == k`` in the fixed order
    above: ``(n_keys,)`` or ``(n_keys, 3)`` f32 from ``keys`` (M,) int32 and
    ``values`` (M,) or (M, 3) f32.

    CUDA tensors sort the keys (``torch.sort(stable=True)``, which keeps
    equal keys in index order) and launch ``kernels/csrc/scatter.cu`` for
    the sums; CPU tensors take :func:`scatter_add_plain`.  The two agree to
    the bit.  Keys outside ``[0, n_keys)`` raise on the CPU and are dropped
    on the card.
    """
    if check_device(keys, values) == "cpu":
        return scatter_add_plain(keys, values, n_keys)
    if keys.dtype != torch.int32 or values.dtype != torch.float32:
        raise TypeError("scatter_add_ordered takes int32 keys and float32 values")
    m = keys.shape[0]
    cols = 1 if values.dim() == 1 else values.shape[1]
    if keys.shape != (m,) or values.shape[0] != m or values.dim() > 2 or cols not in SCATTER_COLS:
        raise ValueError(f"keys (M,) and values (M,) or (M, 3); got {tuple(keys.shape)}, "
                         f"{tuple(values.shape)}")
    sorted_keys, perm = torch.sort(keys, stable=True)
    pieces = torch.empty(max(m * cols, 1), dtype=torch.float32, device=values.device)
    out = torch.zeros((n_keys,) + tuple(values.shape[1:]), dtype=torch.float32,
                      device=values.device)
    scatter_add_ordered.launches += 1
    build.launch("hare_scatter_add_ordered", sorted_keys, perm, values.contiguous(), m, cols,
                 SEGMENT, n_keys, pieces, out)
    return out


scatter_add_ordered.launches = 0


class _GatherRows(torch.autograd.Function):
    """``table[idx]``; its backward is :func:`scatter_add_ordered`."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return scatter_add_ordered(idx, grad.contiguous(), ctx.n_rows), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for int32 ``idx``, differentiable in ``table`` with a
    bitwise-repeatable gradient (:func:`scatter_add_ordered`).  Without a
    gradient to take, a plain ``index_select``."""
    if table.requires_grad and torch.is_grad_enabled():
        return _GatherRows.apply(table, idx)
    return table.index_select(0, idx)
