"""Fixed-order scatter-add, and the gather whose gradient it is.

The JAX package's gradients sum cotangents by an integer key wherever its
forward gathered: the vertex cotangents of the finalize backward onto the
welded vertices (the transpose of ``vertices[iv[:, k]]``,
``hare_tpu/accel/common.py:390``) and the absorption gradient onto the
polygons (the transpose of ``absorption[pid]``,
``hare_tpu/trace/bounce.py:194``).  On CUDA, PyTorch's own scatter-add is a
float atomic, whose order, and so whose last bits, change from run to run.
:func:`scatter_add_ordered` sums in an order fixed by the positions alone,
on the card (``kernels/csrc/scatter.cu``) as on the CPU, so two runs give
the same bits and the card gives the CPU's bits.

The order: the original positions are cut into chunks of ``CHUNK``
consecutive indices; inside a chunk each key's values are summed from +0.0
in index order; a key's chunk sums are added, from +0.0, in chunk order.
A fold from +0.0 never gives -0.0, so a chunk without the key adds an
exact no-op, and a key whose values lie in one chunk is summed exactly as
``index_add_`` sums it.  Cutting the positions keeps each chain of
dependent adds on the card at most ``CHUNK`` long: one chain a key made a
wall hit by 147k rays cost milliseconds.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import build
from ..utils.tracing import spanned
from .common import check_device, stream_buffer

__all__ = ["CHUNK", "gather_rows", "scatter_add_ordered", "scatter_add_plain"]

# Value widths the kernel takes: (M,) or (M, 3).
SCATTER_COLS = (1, 3)
# Original positions summed apart before a key's chunk sums are added.  The
# kernel is passed it and refuses any chunk but its own.
CHUNK = 1024
# The fewest keys a block of the kernel's pass 2 takes.
MIN_RANGE = 32


def scatter_add_plain(keys: torch.Tensor, values: torch.Tensor, n_keys: int) -> torch.Tensor:
    """Plain version, in the kernel's order: each chunk of ``CHUNK``
    original positions summed by key with ``index_add_`` into zeros (on the
    CPU, in index order), the chunks' sums added in order.  Keys outside
    ``[0, n_keys)`` raise."""
    k = keys.long()
    if k.numel() and (int(k.min()) < 0 or int(k.max()) >= n_keys):
        raise IndexError(f"scatter_add_plain: keys outside [0, {n_keys})")
    out = torch.zeros((n_keys,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    for s in range(0, k.shape[0], CHUNK):
        out += torch.zeros_like(out).index_add_(0, k[s:s + CHUNK], values[s:s + CHUNK])
    return out


def scratch_words(m: int, cols: int, n_keys: int) -> int:
    """The int32 words of scratch the kernel takes for ``m`` values of
    ``cols`` columns into ``n_keys`` keys; it refuses fewer.  Per chunk of
    ``CHUNK`` positions: its distinct keys, their sums, their count, where
    its pairs start, their places in their ranges and their count; per
    range of ``MIN_RANGE`` keys (at least as many as pass 2's ranges) a
    count and an offset, and one more offset; per value at most one (range,
    chunk) pair, two words (``kernels/csrc/scatter.cu`` scratch_words)."""
    n_chunks = -(-m // CHUNK)
    ranges = -(-n_keys // MIN_RANGE)
    return n_chunks * (CHUNK * (3 + cols) + 2) + 2 * ranges + 1 + 2 * m


def pass2_plan(m: int, n_keys: int) -> Tuple[int, bool]:
    """How the kernel's pass 2 runs for ``m`` values into ``n_keys`` keys:
    the keys a block takes, and whether it reads the (range, chunk) pairs
    that pass 1 listed (True) or binary-searches every chunk's keys
    (False).  Asks the built library (``kernels/csrc/scatter.cu`` plan), so
    it needs the card."""
    out = torch.zeros(2, dtype=torch.int32)
    build.launch("hare_scatter_plan", m, n_keys, out)
    return int(out[0]), bool(out[1])


def pair_count(keys: torch.Tensor, n_keys: int, key_range: int) -> int:
    """The (range, chunk) pairs the kernel's pass 1 lists for ``keys`` with
    ranges of ``key_range`` keys: the distinct (chunk of ``CHUNK``
    positions, range) of the keys in ``[0, n_keys)``.  For measurement; the
    kernel counts its own."""
    k = keys.long()
    pos = torch.arange(k.numel(), device=k.device)
    inside = (k >= 0) & (k < n_keys)
    ids = pos[inside] // CHUNK * -(-n_keys // key_range) + k[inside] // key_range
    return int(torch.unique(ids).numel())


@spanned("hare.backward.scatter")
def scatter_add_ordered(keys: torch.Tensor, values: torch.Tensor, n_keys: int) -> torch.Tensor:
    """``out[k] = sum of values[i] over keys[i] == k`` in the fixed order
    above: ``(n_keys,)`` or ``(n_keys, 3)`` f32 from ``keys`` (M,) int32 and
    ``values`` (M,) or (M, 3) f32.

    CUDA tensors launch ``kernels/csrc/scatter.cu`` (one ctypes call, the
    output the one allocation: no sort, no fill); CPU tensors take
    :func:`scatter_add_plain`.  The two agree to the bit.  Keys outside
    ``[0, n_keys)`` raise on the CPU and are dropped on the card.
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
    # Every word of its scratch the kernel reads it wrote in the same call,
    # so the scratch is never reset.
    buf = stream_buffer("scatter", values.device, scratch_words(m, cols, n_keys), torch.int32)
    out = torch.empty((n_keys,) + tuple(values.shape[1:]), dtype=torch.float32,
                      device=values.device)
    build.launch("hare_scatter_add_ordered", keys.contiguous(), values.contiguous(), m, cols,
                 n_keys, CHUNK, buf, buf.numel(), out)
    return out


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
