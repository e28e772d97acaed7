"""Design candidates of the port's kernels, side by side on one GPU.

    python -m hare_tpu_torch.benchmarks.kernel_sweep [--kernels k1,b1,b2,b3,a3,k3,k2,hb,gs]
        [--parent DIR] [--reps N]
    python -m hare_tpu_torch.benchmarks.kernel_sweep --order 2:7,1:8,... [--reps N]

With ``--order``, the sweep times K1's ray order instead (:func:`order_study`):
K1 on config 5's and the bench scene's bounces in drawn order, pre-sorted by
the order's key for each ``b:c``, and built with that key ordering them
itself.

Each candidate is a kernel's built source (``kernels/csrc/grid_shoot.cu``
K1, ``brute_shoot.cu`` B1, ``tree_shoot.cu`` B2, ``ropes_shoot.cu`` B3,
``finalize_bwd.cu`` A3, ``energy_histogram.cu`` K3 and its backward HB,
``finalize_hits.cu`` K2, ``gather_probe.cu``'s P2-P4 ``gather_sum`` GS)
with a few statements
replaced (``CANDIDATES``: lanes per ray G, threads per block, one group per
ray instead of the persistent launch, B2's stack in the group's registers,
K1's next cell's meta loaded before this cell's test, B1's rays a thread
and its triangle slabs, A3's block size and its rows moved per ray instead
of through shared memory, K3's chunk of lanes a block, its blocks, its
groups' sums, its fold's loads, and the fold in the same launch, by the
last blocks to finish or behind a cooperative grid-wide barrier, in place
of the second launch; K2's block size; HB's block sizes, the lane count
from which a thread takes four lanes, and its four lanes moved one at a
time; GS in one launch for narrow rows, its rows of 2 elements a thread
a row, its windows' lanes an output, the windows read as 16-byte
words, and its row groups' lanes), or built with
nvcc's default FMA contraction
(``-fmad=true``); the sources themselves stay as built.  With ``--parent``,
the same kernel of another checkout of the repository is one more
candidate, built with that checkout's flags and called through the
parameters its own entry point declares (an older checkout's soft
backward, ``hare_soft_histogram_bwd``, on the soft batches only).  HB's
hard batches also run the torch glue that was the hard backward before it
had a kernel (``trace.bounce.hard_histogram_bwd_plain``), and GS's float
tables the yardstick ``embedding_bag`` + ``sum``.  Each is
compiled by its own
``nvcc -Xptxas -v`` (registers and spills are printed), all at once, into
a shared library loaded with ctypes; a candidate that does not compile is
reported and left out.

The cases: K1 on the bench scene's grid, B2 on its octree and SAH KD tree,
B3 on its rope tree (bench scene of ``bench.py``: 82k triangles, 32,768
rays, the rays of each of 3 bounces of one grid trace), B1 on eval config 1
(the 12-triangle shoebox, 10,000 rays, each of 3 bounces of its own trace)
and on the bench scene's first bounce (the referee's shoot); A3 on the rays
of each of the bench vertex step's 3 bounces (grid) and of eval config 4's
2 (655k triangles, SAH KD tree), with the seeded cotangents of
``chip_smoke.py`` phase 8; K3, hard and soft, on the trace records of the
bench scene (98,304 lanes, 1024 bins), eval config 4 (65,536 lanes, 512
bins) and eval config 3 (the concert hall, octree, 1M rays, 3 bounces:
3,000,000 lanes, 1024 bins); K2 on the rays and winners of each bounce of
the bench (3, grid), eval config 4 (2, SAH KD tree) and eval config 3 (3,
octree, 1M rays); HB on the bench's lanes (hard and soft), config 4's
(soft) and config 3's (hard), with a seeded gradient of the bins; GS on
the JAX probes' inputs, P2, P3 and each of P4's three calls.
Every candidate is checked against the built kernel on each batch: a
traversal bit-equal, pops or steps included, where it is built with the
same flags (otherwise the rays that differ are counted); A3 bit-equal on
every output element where built with the same flags, a parent's
included; K2 and HB the same, the torch glue included; GS's int32 sums
equal and its float sums within ``pallas_probe.sums_agree``; K3 within
``HIST_REL_TOL`` of the histogram's total (its bits depend on the
chunking), its bins that differ counted; A3, K2, K3 and HB also bitwise
equal over two launches; the elements that differ from the parent (or the
glue) are reported.  Each is timed on the device with torch.profiler
(every kernel a call launches: K3 is two, the glue several, and the
kernels a call are reported; GS's two passes also apart), in the order
A B ... B A per batch, so that every candidate is measured before and
after the others.  Config 3's inputs (27-89 MB a call) and GS's tables
(to 50 MB) fit in the card's 50 MB L2 and stay there from call to call,
so those cases are also timed with L2 flushed before each call (a 256 MB
buffer rewritten, its kernel not counted), and after a read of the same
buffer, which leaves no dirty lines for the call to write back: the times
against which the bound, bytes from memory, is a bound.  Prints one line
per case, candidate and batch, then all of it as one JSON line.
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
from .bench_scene import (N_BOUNCES, N_RAYS, bench_setup, bounce_rays, device_ms,
                          profile_kernels)
from .pallas_probe import seconds_per_call

__all__ = ["CANDIDATES", "FMA_FLAGS", "GLUE", "HIST_REL_TOL", "SPECS", "YARDSTICK", "check_order",
           "gs_cases", "gs_given", "hb_given", "k2_given", "k3_given", "order_variant",
           "variant_source"]

BIN_DT = 1e-3  # the bench's and eval configs' bin width (s)

# The built flags with nvcc's default contraction of a * b + c into FMAs.
FMA_FLAGS = tuple(f for f in build.NVCC_FLAGS if f != "-fmad=false")
# K3 candidates against the built K3: the same lanes summed in another
# order where the chunking differs, relative to the histogram's total
# (chip_smoke.py's HIST_REL_TOL).
HIST_REL_TOL = 1e-5
# The hard backward as torch ops, a candidate of HB's hard batches.
GLUE = "torch glue (the parent's hard backward)"
# GS's yardstick on its float tables, a candidate of those batches.
YARDSTICK = "embedding_bag + sum (two torch calls)"
# Bytes rewritten before each flushed call, five times the H100's L2, and
# the name of the kernel that rewrites them (left out of the times).  The
# rewrite leaves L2 full of dirty lines, which the call's own reads then
# write back to memory; so flushed cases are also timed after a read of the
# same bytes (``flush.sum()``, its kernels left out too), which leaves L2
# full of clean lines: "read-flushed".
FLUSH_BYTES, FLUSH_TAG = 256 << 20, "bitwise_not"
# A kernel's parts, timed apart by the names of their kernels: (label, what
# the names hold).
PARTS = {"gs": (("pass 1", "gather_sum_rows"), ("pass 2", "gather_sum_windows"))}
# The kernels held bit-equal to the built one, a parent's and the glue
# included, where built with the same flags.
BIT_EQUAL = ("a3", "k2", "hb")


class Spec(NamedTuple):
    source: str  # the file in kernels/csrc
    entry: str  # its C entry point
    tag: str  # the device kernel's name, as the profiler records it
    args: Tuple[str, ...]  # C names of what the wrapper's *_args function returns
    older: str = ""  # the entry point an older checkout declares in its place
    # Further entry points of the source with the entry's parameters, which
    # a batch picks by name (``given["entry"]``).
    others: Tuple[str, ...] = ()


SPECS = {
    "k1": Spec("grid_shoot.cu", "hare_grid_shoot", "grid_shoot_kernel",
               ("o", "d", "ex", "n", "cell_meta", "win_geom", "win_ids", "fparams", "iparams",
                "best_t", "best_tri", "order")),
    "b1": Spec("brute_shoot.cu", "hare_brute_shoot", "brute_shoot_kernel",
               ("o", "d", "ex", "n", "tri_geom", "tri_meta", "n_tris", "min_t", "top_index",
                "mt", "keys", "best_t", "best_tri")),
    "b2": Spec("tree_shoot.cu", "hare_tree_shoot", "tree_shoot_kernel",
               ("o", "d", "ex", "n", "child_box", "child_info", "win_geom", "win_ids", "min_t",
                "iparams", "best_t", "best_tri", "pops", "err")),
    "b3": Spec("ropes_shoot.cu", "hare_ropes_shoot", "ropes_shoot_kernel",
               ("o", "d", "ex", "n", "node_tab", "split", "box", "leaf_win", "ropes", "win_geom",
                "win_ids", "fparams", "iparams", "best_t", "best_tri", "steps", "err")),
    # A3, K3, K2 and HB are timed over every kernel a call launches (tag
    # ""), and called with the parameters their case gives by name (args
    # unused).
    "a3": Spec("finalize_bwd.cu", "hare_finalize_hits_bwd", "", ()),
    "k3": Spec("energy_histogram.cu", "hare_energy_histogram", "", ()),
    "k2": Spec("finalize_hits.cu", "hare_finalize_hits", "", ()),
    "hb": Spec("energy_histogram.cu", "hare_histogram_bwd", "", (), "hare_soft_histogram_bwd"),
    "gs": Spec("gather_probe.cu", "hare_gather_sum_f32", "", (), "",
               ("hare_gather_sum_i32", "hare_gather_sum_i32_f32")),
}
CALL_KERNELS = ("a3", "k3", "k2", "hb", "gs")


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

# K3's statements that the fold candidates replace: the kernel's last
# parameter, its end (the block's row written), the helpers' place and the
# launches.
_K3_PARAM = "                                 int n_bins, float bin_dt, float* __restrict__ partials) {"
_K3_PARAM_HIST = ("                                 int n_bins, float bin_dt, float* __restrict__ partials,"
                  " int* __restrict__ counters, float* __restrict__ hist) {")
_K3_ROW_END = """    reinterpret_cast<float4*>(out)[q] = s;
  }
}
"""
_K3_HELPERS = "// Rows of a segment of R blocks' rows: ceil(R / kSegs)."
_K3_ENTRY = """                                     float* partials, long long n_partials, float* hist,
                                     void* stream) {"""
_K3_ENTRY_COUNTERS = """                                     float* partials, long long n_partials, int* counters,
                                     long long n_counters, float* hist, void* stream) {"""
_K3_CHECK = """  if (tiles * blocks * kTile > n_partials) return static_cast<int>(cudaErrorInvalidValue);"""
_K3_CHECK_COUNTERS = """  if (tiles * (blocks + kSegs) * kTile > n_partials || tiles * (1 + kSegs) > n_counters)
    return static_cast<int>(cudaErrorInvalidValue);"""
_K3_LAUNCHES = """  if (soft)
    hist_rows_kernel<true><<<grid, kThreads, 0, s>>>(energy, time, hit, n, chunk, n_bins, bin_dt,
                                                      partials);
  else
    hist_rows_kernel<false><<<grid, kThreads, 0, s>>>(energy, time, hit, n, chunk, n_bins, bin_dt,
                                                       partials);
  hist_fold_kernel<<<(n_bins + 31) / 32, kThreads, 0, s>>>(partials, static_cast<int>(blocks),
                                                           n_bins, hist);
"""
# K3 in one launch: the last block of each segment to finish adds the
# segment's rows, and the last segment to finish adds the segment sums (a
# counter per segment and tile, left at zero); the same order and bits.
_K3_ONE_LAUNCH = (
    (_K3_PARAM, _K3_PARAM_HIST),
    (_K3_HELPERS, """// Adds rows[k * kTile] for k < count in order from +0.0, four bins (the
// q-th 16 bytes of a row) a thread, eight loads in flight.
__device__ __forceinline__ float4 fold_rows(const float* rows, int count, int q) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < count; k0 += 8) {
    float4 r[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k0 + k < count)
        r[k] = __ldcg(reinterpret_cast<const float4*>(rows + static_cast<long long>(k0 + k) *
                                                      kTile) + q);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k0 + k < count) {
        s.x += r[k].x;
        s.y += r[k].y;
        s.z += r[k].z;
        s.w += r[k].w;
      }
  }
  return s;
}

// The last of `members` blocks to reach *counter (true on all its
// threads), which sets it back to 0; every block's writes before the call
// are visible to the last after it.
__device__ __forceinline__ bool last_to_arrive(int* counter, int members) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(counter, 1) == members - 1;
    if (last) {
      atomicExch(counter, 0);
      __threadfence();
    }
  }
  __syncthreads();
  return last;
}

""" + _K3_HELPERS),
    (_K3_ROW_END, """    reinterpret_cast<float4*>(out)[q] = s;
  }
  const int blocks = gridDim.x, per = seg_rows(blocks), segs = (blocks + per - 1) / per;
  const int g = blockIdx.x / per, first = g * per, members = min(per, blocks - first);
  const float* tile_rows = partials + static_cast<long long>(blockIdx.y) * blocks * kTile;
  float* seg_sums = partials + (static_cast<long long>(gridDim.y) * blocks +
                                static_cast<long long>(blockIdx.y) * kSegs) * kTile;
  int* tile_counters = counters + blockIdx.y * (1 + kSegs);
  if (!last_to_arrive(tile_counters + 1 + g, members)) return;
  for (int q = threadIdx.x; q < kTile / 4; q += kThreads)
    reinterpret_cast<float4*>(seg_sums + static_cast<long long>(g) * kTile)[q] =
        fold_rows(tile_rows + static_cast<long long>(first) * kTile, members, q);
  if (!last_to_arrive(tile_counters, segs)) return;
  for (int q = threadIdx.x; q < kTile / 4; q += kThreads) {
    const float4 v = fold_rows(seg_sums, segs, q);
    const int b = 4 * q;
    if (b < tile) hist[b0 + b] = v.x;
    if (b + 1 < tile) hist[b0 + b + 1] = v.y;
    if (b + 2 < tile) hist[b0 + b + 2] = v.z;
    if (b + 3 < tile) hist[b0 + b + 3] = v.w;
  }
}
"""),
    (_K3_ENTRY, _K3_ENTRY_COUNTERS),
    (_K3_CHECK, _K3_CHECK_COUNTERS),
    (_K3_LAUNCHES, """  if (soft)
    hist_rows_kernel<true><<<grid, kThreads, 0, s>>>(energy, time, hit, n, chunk, n_bins, bin_dt,
                                                      partials, counters, hist);
  else
    hist_rows_kernel<false><<<grid, kThreads, 0, s>>>(energy, time, hit, n, chunk, n_bins, bin_dt,
                                                       partials, counters, hist);
"""),
)
# K3 in one cooperative launch (every block resident at once, or it is
# refused): all blocks meet at a grid-wide barrier, then fold the bins 32
# at a time as the second launch does; the same order and bits.
_K3_GRID_BARRIER = (
    (_K3_PARAM, _K3_PARAM_HIST),
    ("template <bool SOFT>\n__global__ void hist_rows_kernel(", """// All `blocks` blocks of a cooperative launch meet: counter[0] counts the
// arrivals, counter[1] is the barrier's generation.
__device__ void grid_barrier(int* counter, int blocks) {
  __shared__ int gen;
  __syncthreads();
  if (threadIdx.x == 0) {
    gen = *reinterpret_cast<volatile int*>(&counter[1]);
    __threadfence();
    if (atomicAdd(&counter[0], 1) == blocks - 1) {
      atomicExch(&counter[0], 0);
      __threadfence();
      atomicAdd(&counter[1], 1);
    } else {
      while (*reinterpret_cast<volatile int*>(&counter[1]) == gen) {
      }
      __threadfence();
    }
  }
  __syncthreads();
}

// Bins 32 fg .. 32 fg + 31 folded as the second launch's block fg does.
__device__ void fold32(const float* partials, int blocks, int n_bins, int fg, float* hist) {
  __shared__ float seg_sum[kSegs][32];
  const int col = threadIdx.x % 32, seg = threadIdx.x / 32;
  const int b = fg * 32 + col;
  const float* rows = partials + static_cast<long long>(b / kTile) * blocks * kTile + b % kTile;
  const int per = seg_rows(blocks), k0 = seg * per, count = max(0, min(per, blocks - k0));
  float s = 0.f;
  if (b < n_bins) {
#pragma unroll 8
    for (int k = 0; k < count; ++k) s += rows[static_cast<long long>(k0 + k) * kTile];
  }
  seg_sum[seg][col] = s;
  __syncthreads();
  if (seg == 0 && b < n_bins) {
    float t = 0.f;
    for (int j = 0; j < kSegs; ++j) t += seg_sum[j][col];
    hist[b] = t;
  }
  __syncthreads();
}

template <bool SOFT>
__global__ void hist_rows_kernel("""),
    (_K3_ROW_END, """    reinterpret_cast<float4*>(out)[q] = s;
  }
  grid_barrier(counters, gridDim.x * gridDim.y);
  const int flat = blockIdx.y * gridDim.x + blockIdx.x;
  for (int fg = flat; fg < (n_bins + 31) / 32; fg += gridDim.x * gridDim.y)
    fold32(partials, gridDim.x, n_bins, fg, hist);
}
"""),
    (_K3_ENTRY, _K3_ENTRY_COUNTERS),
    (_K3_CHECK, _K3_CHECK_COUNTERS),
    (_K3_LAUNCHES, """  const void* fn = soft ? reinterpret_cast<const void*>(hist_rows_kernel<true>)
                        : reinterpret_cast<const void*>(hist_rows_kernel<false>);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0);
  if (blocks * tiles > static_cast<long long>(per_sm) * sms)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  long long chunk_arg = chunk;
  void* args[] = {&energy, &time, &hit, &n, &chunk_arg, &n_bins, &bin_dt, &partials, &counters,
                  &hist};
  cudaLaunchCooperativeKernel(fn, grid, dim3(kThreads), args, 0, s);
"""),
)
# K3 with the leader walking its peers' set bits, one dependent read of a
# slot each (the design first tried): the same adds in the same order.
_K3_WALK = ((
    """    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 32; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(slots + k);
      acc += (peers >> k) & 1u ? v.x : 0.f;
      acc += (peers >> (k + 1)) & 1u ? v.y : 0.f;
      acc += (peers >> (k + 2)) & 1u ? v.z : 0.f;
      acc += (peers >> (k + 3)) & 1u ? v.w : 0.f;
    }
""", """    float acc = 0.f;
    for (unsigned m = peers; m != 0; m &= m - 1) acc += slots[__ffs(m) - 1];
"""),)
# K3's fold with all of a segment's rows loaded at once, one round trip
# where the loop takes one for every eight rows.
_K3_FOLD_AT_ONCE = ((
    """  float s = 0.f;
  if (b < n_bins) {
#pragma unroll 8
    for (int k = 0; k < count; ++k) s += rows[static_cast<long long>(k0 + k) * kTile];
  }
""", """  constexpr int kSegRows = (kMaxBlocks + kSegs - 1) / kSegs;
  float r[kSegRows];
#pragma unroll
  for (int k = 0; k < kSegRows; ++k)
    if (b < n_bins && k < count) r[k] = __ldcg(rows + static_cast<long long>(k0 + k) * kTile);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kSegRows; ++k)
    if (b < n_bins && k < count) s += r[k];
"""),)

# HB's lane count from which a thread takes four lanes, and its four lanes
# moved one at a time, never as 16-byte words.
_HB_WIDE = "kWideMin = 1 << 20;"
_HB_VEC = ("if (vec && i0 + LANES <= n) {", "if (false && vec && i0 + LANES <= n) {")

# GS in one launch for narrow rows: a group of lanes an output, each lane
# summing rows i = l, l + g, ... of its window straight from the table (each
# row as pass 1 sums it: words or elements from 0 in order), then pass 2's
# fold; the same adds as the two passes, without the row sums' scratch.
_GS_ONE_PASS = (
    ("unsigned blocks_for(long long threads) {", """template <typename T, typename A, typename Out>
__global__ void __launch_bounds__(kThreads)
gather_sum_one_pass(const T* __restrict__ tab, unsigned n, int width, const int* __restrict__ idx,
                    int n_out, int iters, int g, Out* __restrict__ out) {
  using V = typename Vec4<T>::type;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long r = t / g;
  const int lane = static_cast<int>(t % g);
  unsigned k = (wrap_start(__ldg(idx + (r < n_out ? r : 0)), n) + lane) % n;
  const unsigned step = static_cast<unsigned>(g) % n;
  A acc = 0;
#pragma unroll 4
  for (int i = lane; i < iters; i += g) {
    A row = 0;
    if (width % 4 == 0) {
      const V* words = reinterpret_cast<const V*>(tab) + static_cast<size_t>(k) * (width / 4);
      for (int v = 0; v < width / 4; ++v) row += word_sum<A>(__ldg(words + v));
    } else {
      for (int j = 0; j < width; ++j) row += term<A>(__ldg(tab + static_cast<size_t>(k) * width + j));
    }
    acc += row;
    k += step;
    if (k >= n) k -= n;
  }
  acc = fold_group(acc, g);
  if (r < n_out && lane == 0) out[r] = static_cast<Out>(acc);
}

unsigned blocks_for(long long threads) {"""),
    ("""  if (iters > 0) {
    row_sums<T, A>(tab, n, width, sums, s);""", """  if (width <= 2 || width == 4 || width == 8) {
    const int g1 = window_lanes(n_out, iters);
    gather_sum_one_pass<T, A, Out><<<blocks_for(static_cast<long long>(n_out) * g1), kThreads, 0,
                                     s>>>(tab, static_cast<unsigned>(n), width, idx, n_out, iters,
                                          g1, out);
    return static_cast<int>(cudaGetLastError());
  }
  if (iters > 0) {
    row_sums<T, A>(tab, n, width, sums, s);"""),
)
# GS's pass 1 on rows of 2 elements (P3, P4's meta) by the path of other
# widths, a thread a row adding its elements one load at a time.
_GS_PAIR = ("  } else if (width == 2) {", "  } else if (false) {")
# GS's pass 2 with one thread an output, adding its window in i order.
_GS_LANES = ("  while (g < 32 && g < iters &&", "  while (false && g < 32 && g < iters &&")
# GS's pass 2 lanes an output by another rule: up to 4 row sums a lane and
# groups to fill the whole card (the first rule measured), or up to 16 and
# a quarter of the card.
_GS_RULE = "(8LL * g < iters || static_cast<long long>(n_out) * g < 66LL * 2048)"
_GS_WHOLE = (_GS_RULE, "(4LL * g < iters || static_cast<long long>(n_out) * g < 132LL * 2048)")
_GS_QUARTER = (_GS_RULE, "(16LL * g < iters || static_cast<long long>(n_out) * g < 33LL * 2048)")
# GS's pass 1 with groups of at most 8 lanes a row: more words a lane, and
# a grid that fits on the card at once for P2 and P4's window rows.
_GS_ROW_LANES = ("(nv & -nv) < 32 ? (nv & -nv) : 32;", "(nv & -nv) < 8 ? (nv & -nv) : 8;")
# GS's pass 2 reading the row sums as 16-byte words: lane l of a group takes
# the aligned words l, l + g, ... that cover a window that does not wrap,
# adding the elements inside it in order (the scratch is padded to a whole
# word; the sweep allocates it so); a window that wraps is read as before.
_GS_WORDS = (
    ("template <> struct Vec4<int> { using type = int4; };",
     "template <> struct Vec4<int> { using type = int4; };\n"
     "template <> struct Vec4<unsigned> { using type = uint4; };"),
    ("""  unsigned k = (wrap_start(__ldg(idx + (r < n_out ? r : 0)), n) + lane) % n;
  const unsigned step = static_cast<unsigned>(g) % n;
  A acc = 0;
#pragma unroll 4
  for (int i = lane; i < iters; i += g) {
    acc += __ldg(sums + k);
    k += step;
    if (k >= n) k -= n;
  }
""", """  const unsigned w0 = wrap_start(__ldg(idx + (r < n_out ? r : 0)), n);
  A acc = 0;
  if (static_cast<long long>(w0) + iters <= n) {
    const auto* words = reinterpret_cast<const typename Vec4<A>::type*>(sums);
    const unsigned end = w0 + static_cast<unsigned>(iters);
#pragma unroll 2
    for (unsigned q = w0 / 4 + lane; 4 * q < end; q += g) {
      const auto x = __ldg(words + q);
      const unsigned e = 4 * q;
      if (e >= w0) acc += x.x;
      if (e + 1 >= w0 && e + 1 < end) acc += x.y;
      if (e + 2 >= w0 && e + 2 < end) acc += x.z;
      if (e + 3 >= w0 && e + 3 < end) acc += x.w;
    }
  } else {
    unsigned k = (w0 + lane) % n;
    const unsigned step = static_cast<unsigned>(g) % n;
    for (int i = lane; i < iters; i += g) {
      acc += __ldg(sums + k);
      k += step;
      if (k >= n) k -= n;
    }
  }
"""),
    ("  const int g = window_lanes(n_out, iters);", "  const int g = window_lanes(n_out, (iters + 3) / 4 + 1);"),
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
        ("R2 slabs (built)", (), None),
        ("R4", (("constexpr int kWideRays = 2;", "constexpr int kWideRays = 4;"),), None),
        ("R2 8 blocks an SM", (("constexpr int kTargetBlocks = 132 * 16;",
                                "constexpr int kTargetBlocks = 132 * 8;"),), None),
        ("R2 one slab", (("constexpr int kTargetBlocks = 132 * 16;",
                          "constexpr int kTargetBlocks = 1;"),), None),
        ("R2 -fmad=true", (), FMA_FLAGS),
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
    "a3": (
        ("block 128, staged rows (built)", (), None),
        ("block 64", (("constexpr int kBlock = 128;", "constexpr int kBlock = 64;"),), None),
        ("block 256", (("constexpr int kBlock = 128;", "constexpr int kBlock = 256;"),), None),
        ("block 128, per-ray rows", (("const bool vec = n - base >= kBlock",
                                      "const bool vec = false && n - base >= kBlock"),), None),
        ("block 128 -fmad=true", (), FMA_FLAGS),
    ),
    "k3": (
        ("two launches, chunk 512 (built)", (), None),
        ("one launch", _K3_ONE_LAUNCH, None),
        ("grid barrier", _K3_GRID_BARRIER, None),
        ("leader walks its peers' bits", _K3_WALK, None),
        ("fold loads a segment at once", _K3_FOLD_AT_ONCE, None),
        ("chunk 1024", (("kMinChunk = 512;", "kMinChunk = 1024;"),), None),
        ("at most 264 blocks", (("kMaxBlocks = 528;", "kMaxBlocks = 264;"),), None),
    ),
    "k2": (
        ("block 128 (built)", (), None),
        ("block 64", (("constexpr int kBlock = 128;", "constexpr int kBlock = 64;"),), None),
        ("block 256", (("constexpr int kBlock = 128;", "constexpr int kBlock = 256;"),), None),
        ("block 128 -fmad=true", (), FMA_FLAGS),
    ),
    "gs": (
        ("two passes (built)", (), None),
        ("rows of 2 elements a thread a row, element by element", (_GS_PAIR,), None),
        ("one pass for rows of 1, 2, 4 or 8 elements", _GS_ONE_PASS, None),
        ("windows one thread an output, in i order", (_GS_LANES,), None),
        ("windows up to 4 row sums a lane, the whole card", (_GS_WHOLE,), None),
        ("windows up to 16 row sums a lane, a quarter of the card", (_GS_QUARTER,), None),
        ("windows read as 16-byte words", _GS_WORDS, None),
        ("rows of over 4 words at most 8 lanes a row", (_GS_ROW_LANES,), None),
    ),
    "hb": (
        ("1 lane a thread below 2^20 lanes, 4 above (built)", (), None),
        ("4 lanes a thread always", ((_HB_WIDE, "kWideMin = 0;"),), None),
        ("1 lane a thread always", ((_HB_WIDE, "kWideMin = 1LL << 62;"),), None),
        ("1 lane a thread in blocks of 128", (("kNarrowBlock = 256;", "kNarrowBlock = 128;"),),
         None),
        ("4 lanes a thread in blocks of 256", (("kWideBlock = 128;", "kWideBlock = 256;"),), None),
        ("4 lanes a thread, moved lane by lane", (_HB_VEC,), None),
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
    entry: str = ""  # its entry point, where not the spec's


def _build(entry: str, variants: List[Variant], out_dir: Path, prefix: str,
           leave_out_failed: bool = False, others: Tuple[str, ...] = ()):
    """Compile every variant into its own shared library, all nvcc
    processes at once; returns ``{label: (C functions, C parameters, ptxas
    report)}``, the C functions a dict keyed by ``entry`` and ``others``
    (the variant's own entry point under ``entry``), the parameters
    ``entry``'s.  A variant that does not compile raises, or, with
    ``leave_out_failed``, is printed and left out."""
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
            msg = f"nvcc failed ({rc}) for {v.label}:\n{' '.join(cmd)}\n{err}"
            if not leave_out_failed:
                raise RuntimeError(msg)
            print(f"sweep left out: {msg}")
            continue
        loaded = ctypes.CDLL(str(lib))
        fns = {}
        for key, name in ((entry, v.entry or entry), *((o, o) for o in others)):
            fns[key] = getattr(loaded, name)
            fns[key].argtypes = [t for _, t in _c_params(v.text, name)]
            fns[key].restype = ctypes.c_int
        params = _c_params(v.text, v.entry or entry)
        # Registers and spills of each instance (watertight and MT, each K).
        report = [line.replace("ptxas info    :", "").strip() for line in err.splitlines()
                  if "registers" in line or "spill" in line]
        out[v.label] = (fns, params, report)
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


class CallCase(NamedTuple):
    """A3, K3, K2 or HB on some batches: ``(label, make)`` pairs, where
    ``make()`` gives the entry point's parameters by name and the fresh
    outputs they name; ``flushed``: timed with L2 flushed too."""

    name: str
    kernel: str  # a key of SPECS in CALL_KERNELS
    batches: list
    flushed: bool = False


def k3_given(lanes, n_bins: int, bin_dt: float, soft: bool):
    """K3's parameters on ``lanes`` (energy, time, hit), with scratch and
    zeroed fold counters (the one-launch candidates') enough for any
    candidate and a parent, and the histogram they name: ``(given,
    (hist,))``."""
    from ..trace.bounce import HIST_MAX_BLOCKS, HIST_TILE

    energy, time, hit = (x.contiguous() for x in lanes)
    dev = energy.device
    tiles = -(-n_bins // HIST_TILE)
    # A row for every block and for each segment of them.
    partials = torch.empty(tiles * 2 * HIST_MAX_BLOCKS * HIST_TILE, device=dev)
    counters = torch.zeros(tiles * 64, dtype=torch.int32, device=dev)
    hist = torch.empty(n_bins, device=dev)
    return dict(energy=energy, time=time, hit=hit, n=energy.numel(), n_bins=n_bins,
                bin_dt=bin_dt, soft=int(soft), partials=partials, n_partials=partials.numel(),
                counters=counters, n_counters=counters.numel(), hist=hist), (hist,)


def k2_given(scene, rays, best_t, best_tri):
    """K2's parameters on one shoot's rays and winners (watertight), into a
    fresh record allocated as the wrapper allocates it, and the record's
    nine fields: ``(given, fields)``."""
    from ..accel.common import empty_hit_record

    n = rays.origin.shape[0]
    out = empty_hit_record(n, rays.origin.device)
    return dict(tri_geom=scene.tri_geom, tri_meta=scene.tri_meta, best_t=best_t,
                best_tri=best_tri, o=rays.origin.contiguous(), d=rays.direction.contiguous(),
                n=n, mt=0, hit=out.hit, t=out.t, u=out.u, v=out.v, point=out.point,
                poly=out.poly_id, tri=out.tri_id, normal=out.normal, nbr=out.edge_nbr), tuple(out)


def hb_given(lanes, grad_hist, n_bins: int, bin_dt: float, soft: bool):
    """HB's parameters on ``lanes`` (energy, time, hit) and the bins'
    gradient, with fresh d(energy) and d(time) (an older soft entry point
    writes both), and the outputs of the mode: ``(given, (d_energy,[
    d_time]))``."""
    energy, time, hit = (x.contiguous() for x in lanes)
    d_energy, d_time = torch.empty_like(energy), torch.empty_like(energy)
    given = dict(energy=energy, time=time, hit=hit, grad_hist=grad_hist,
                 grad_stride=grad_hist.stride(0), n=energy.numel(), n_bins=n_bins, bin_dt=bin_dt,
                 soft=int(soft), d_energy=d_energy, d_time=d_time, torch=not soft)
    return given, (d_energy, d_time) if soft else (d_energy,)


def gs_given(tab, idx, iters: int, out_dtype, abs_terms=None):
    """GS's parameters on a table and its indices, with fresh row-sum
    scratch (padded to whole 16-byte words, which one candidate reads) and
    sums, the entry point of the (table, sum) type pair and,
    for a float table, the windows' row indices of the yardstick and the
    sums of the terms' magnitudes (``abs_terms``) that the check bounds
    with: ``(given, (out,))``."""
    from .pallas_probe import _GATHER_ENTRIES

    out = torch.empty(idx.shape[0], dtype=out_dtype, device=tab.device)
    given = dict(tab=tab, n=tab.shape[0], width=tab.shape[1], idx=idx, n_out=idx.shape[0],
                 iters=iters, sums=torch.empty(-(-tab.shape[0] // 4) * 4, dtype=out_dtype,
                                               device=tab.device),
                 out=out, entry=_GATHER_ENTRIES[(tab.dtype, out_dtype)], abs_terms=abs_terms,
                 torch=tab.dtype == torch.float32)
    if given["torch"]:
        given["windows"] = (idx.to(torch.int64)[:, None]
                            + torch.arange(iters, device=tab.device)) % tab.shape[0]
    return given, (out,)


def _yardstick(given):
    """GS's function in two torch calls: the windows' rows summed by
    ``embedding_bag``, then each bag's columns."""
    return (torch.nn.functional.embedding_bag(given["windows"], given["tab"], mode="sum").sum(1),)


def _gather_agrees(got: torch.Tensor, ref: torch.Tensor, given) -> bool:
    """A GS candidate against the built kernel: int32 sums equal, float
    sums within ``pallas_probe.sums_agree`` (small integers summed in
    float32 are exact either way)."""
    from .pallas_probe import sums_agree

    if got.dtype == torch.int32 or given["abs_terms"] is None:
        return torch.equal(got, ref)
    return sums_agree(got, ref, given["abs_terms"])


def _glue(given):
    """The hard backward as the parent's torch ops, on HB's parameters."""
    from ..trace.bounce import hard_histogram_bwd_plain

    return (hard_histogram_bwd_plain(given["time"], given["hit"], given["grad_hist"],
                                     given["n_bins"], given["bin_dt"]),)


def gs_cases(dev) -> List[CallCase]:
    """GS on the JAX probes' inputs, one batch a call: P2, P3 and each of
    P4's three calls, timed warm and with L2 flushed (P2's 18 MB and P4's
    50 MB tables sit in the 50 MB L2 from call to call)."""
    from . import pallas_probe as pp
    from . import r4_dyngather_probe as r4

    calls = [("P2", *pp.gather_inputs(), 50, torch.float32),
             ("P3", *pp.meta_gather_inputs(), 50, torch.int32)]
    for (A, B, dtype, iters, label), name in zip(r4.CALLS, ("P4 meta", "P4 win", "P4 ctx")):
        tab, idx = r4.probe_inputs(A, B, dtype)
        calls.append((name, tab, idx.reshape(-1), iters, torch.float32))
    batches = []
    for name, tab, idx, iters, out_dtype in calls:
        tab, idx = torch.from_numpy(tab).to(dev), torch.from_numpy(idx).to(dev)
        abs_terms = (pp.gather_sum_plain(tab.abs(), idx, iters, torch.float32)
                     if tab.dtype == torch.float32 else None)
        batches.append((f"{name} {tuple(tab.shape)} x {iters}",
                        lambda tab=tab, idx=idx, iters=iters, out_dtype=out_dtype,
                        abs_terms=abs_terms: gs_given(tab, idx, iters, out_dtype, abs_terms)))
    return [CallCase("GS probes", "gs", batches, flushed=True)]


def _call_cases(dev, kernels) -> List[CallCase]:
    import hare_tpu_torch as th
    from hare_tpu_torch.accel import common, tree, voxel

    from . import a3_check, configs

    cases = gs_cases(dev) if "gs" in kernels else []
    if not {"a3", "k2", "k3", "hb"} & set(kernels):
        return cases
    _, sp, rays, absorption = bench_setup(dev)
    c4 = configs.config4_setup(dev)
    c3 = configs.config3_setup(dev) if {"k2", "k3", "hb"} & set(kernels) else None
    if "a3" in kernels:
        def a3_batches(part, shoot, rays_, absorption_, n_bounces, seed0):
            out = []
            for b, r in enumerate(bounce_rays(part, rays_, absorption_, n_bounces), 1):
                best_t, best_tri = shoot(r, part.struct)
                hr = common.finalize_hits(part.scene, r, best_t, best_tri)
                args = (part.scene.vertices, part.scene.tri_meta, best_tri, hr.t, hr.hit,
                        r.origin, r.direction,
                        a3_check.seeded_cotangents(r.origin.shape[0], seed0 + b, dev))
                out.append((f"bounce {b}", lambda args=args: a3_check.a3_given(args)))
            return out

        # chip_smoke.py phase 8's seeds: bounce b takes b, config 4's 10 + b.
        cases.append(CallCase("A3 bench vertex step", "a3",
                              a3_batches(sp, voxel.grid_shoot, rays, absorption, N_BOUNCES, 0)))
        cases.append(CallCase("A3 config 4", "a3",
                              a3_batches(c4.partition, tree.tree_shoot, c4.rays, c4.absorption,
                                         c4.n_bounces, 10)))
    if "k2" in kernels:
        def k2_batches(part, shoot, rays_, absorption_, n_bounces):
            out = []
            for b, r in enumerate(bounce_rays(part, rays_, absorption_, n_bounces), 1):
                best_t, best_tri = shoot(r, part.struct)
                out.append((f"bounce {b}", lambda part=part, r=r, t=best_t, i=best_tri:
                            k2_given(part.scene, r, t, i)))
            return out

        cases.append(CallCase("K2 bench", "k2",
                              k2_batches(sp, voxel.grid_shoot, rays, absorption, N_BOUNCES)))
        cases.append(CallCase("K2 config 4", "k2",
                              k2_batches(c4.partition, tree.tree_shoot, c4.rays, c4.absorption,
                                         c4.n_bounces)))
        cases.append(CallCase("K2 config 3", "k2",
                              k2_batches(c3.partition, tree.tree_shoot, c3.rays, c3.absorption,
                                         c3.n_bounces), flushed=True))
    if {"k3", "hb"} & set(kernels):
        def lanes(part, rays_, absorption_, n_bounces):
            with torch.no_grad():
                res = th.trace_rays(part.scene, rays_, absorption_, n_bounces, part.shoot_fn,
                                    aux=part.aux)
            return res.energy, res.time, res.hit

        trace = {"bench": (lanes(sp, rays, absorption, N_BOUNCES), 1024),
                 "config 4": (lanes(c4.partition, c4.rays, c4.absorption, c4.n_bounces),
                              c4.n_bins),
                 "config 3": (lanes(c3.partition, c3.rays, c3.absorption, c3.n_bounces),
                              c3.n_bins)}
    if "k3" in kernels:
        for where, (lanes_, n_bins) in trace.items():
            cases.append(CallCase(f"K3 {where}", "k3", [
                (mode, lambda lanes_=lanes_, n_bins=n_bins, soft=soft:
                 k3_given(lanes_, n_bins, BIN_DT, soft))
                for mode, soft in (("hard", False), ("soft", True))], where == "config 3"))
    if "hb" in kernels:
        # The main paths' modes: hard on every absorption path, soft on the
        # vertex paths (the bench vertex step and config 4 (b)).
        for where, modes in (("bench", ("hard", "soft")), ("config 4", ("soft",)),
                             ("config 3", ("hard",))):
            lanes_, n_bins = trace[where]
            grad = torch.randn(n_bins, generator=torch.Generator().manual_seed(n_bins)).to(dev)
            cases.append(CallCase(f"HB {where}", "hb", [
                (mode, lambda lanes_=lanes_, grad=grad, n_bins=n_bins, soft=mode == "soft":
                 hb_given(lanes_, grad, n_bins, BIN_DT, soft))
                for mode in modes], where == "config 3"))
    return cases


def _bits_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements of two like tensors whose bits differ."""
    if a.element_size() == 4:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def _max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| of two like tensors, 0 where they are equal (so
    equal infinities, K2's t of a miss, count 0)."""
    diff = torch.where(a == b, 0.0, (a.double() - b.double()).abs())
    return float(diff.max()) if diff.numel() else 0.0


def _takes(params, given) -> bool:
    """Whether a candidate takes a batch: an entry point without a ``soft``
    parameter (an older checkout's soft backward) the soft batches only; a
    torch candidate (``params`` None) the batches that say so
    (``given["torch"]``: the glue HB's hard batches, the yardstick GS's
    float tables)."""
    if params is None:
        return given.get("torch", False)
    if "soft" not in given:
        return True
    return given["soft"] == 1 or any(name == "soft" for name, _ in params)


def _bind(entry, name, given, out):
    """A call of a built entry point on ``given`` that returns ``out`` (the
    one ``given["entry"]`` names, else ``name``), or of the torch glue
    (``params`` None), which returns its own."""
    fns, params, _ = entry
    if params is None:
        return lambda: fns(given)
    call = _caller(fns[given.get("entry", name)], params, given)

    def run():
        call()
        return out

    return run


def _run_call_case(case: CallCase, built_libs, variants, reps: int, rec: dict) -> None:
    """Check every candidate of ``case`` against the built kernel and
    itself, then time each, A B ... B A per batch."""
    c_rec = rec[case.name] = {v.label: {"ptxas": built_libs[v.label][2],
                                        "flags": " ".join(v.flags)}
                              for v in variants}
    built = next(v for v in variants if v.label == CANDIDATES[case.kernel][0][0])
    stream = torch.cuda.current_stream().cuda_stream
    for label_b, make in case.batches:
        outs, ref = {}, None
        for v in [built] + [v for v in variants if v is not built]:
            entry = built_libs[v.label]
            runs = []
            for _ in range(2):
                given, out = make()
                if not _takes(entry[1], given):
                    break
                call = _bind(entry, SPECS[case.kernel].entry, dict(given, stream=stream), out)
                runs.append(call())
                torch.cuda.synchronize()
            if not runs:
                continue
            again = sum(_bits_differ(x, y) for x, y in zip(*runs))
            if again:
                raise AssertionError(f"{case.name} {label_b} {v.label}: two launches differ in "
                                     f"{again} elements")
            got = runs[0]
            if ref is None:
                ref = got
            differ = sum(_bits_differ(x, y) for x, y in zip(got, ref))
            err = max(_max_abs_diff(x, y) for x, y in zip(got, ref))
            if case.kernel in BIT_EQUAL and v.flags == built.flags and differ:
                raise AssertionError(f"{case.name} {label_b} {v.label}: {differ} elements differ "
                                     "from the built kernel")
            if (case.kernel == "gs" and entry[1] is not None
                    and not _gather_agrees(got[0], ref[0], given)):
                raise AssertionError(f"{case.name} {label_b} {v.label}: differs from the built "
                                     "kernel beyond pallas_probe.sums_agree")
            total = float(ref[0].double().sum()) if case.kernel == "k3" else 0.0
            if case.kernel == "k3" and err > HIST_REL_TOL * total:
                raise AssertionError(f"{case.name} {label_b} {v.label}: differs by {err} of the "
                                     f"total {total}")
            outs[v.label] = (call, differ, err, got)
        parent = next((outs[label][3] for label in ("parent", GLUE) if label in outs), None)
        order = [v.label for v in variants if v.label in outs]
        modes = ("warm", "flushed", "read-flushed") if case.flushed else ("warm",)
        times = {(label, mode): [] for label in order for mode in modes}
        parts = {(label, mode): [] for label in order for mode in modes}
        launched = {}
        flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=ref[0].device)
        # The read's kernels, by name, to leave out of the read-flushed times.
        read_names = set(profile_kernels(lambda: flush.sum(), 2)) if case.flushed else set()
        before = {"warm": None, "flushed": flush.bitwise_not_, "read-flushed": flush.sum}
        for label in order + order[::-1]:
            call = outs[label][0]
            for mode in modes:
                pre = before[mode]
                kernels = profile_kernels(
                    call if pre is None else lambda call=call, pre=pre: (pre(), call()), reps)
                kernels = {name: tk for name, tk in kernels.items()
                           if FLUSH_TAG not in name and name not in read_names}
                times[label, mode].append(_call_ms(kernels, reps))
                parts[label, mode].append({part: _call_ms(
                    {name: tk for name, tk in kernels.items() if tag in name}, reps)
                    for part, tag in PARTS.get(case.kernel, ())})
                if mode == "warm":
                    launched[label] = sum(round(k / reps) for _, k in kernels.values())
        del flush
        for label in order:
            _, differ, err, got = outs[label]
            vs_parent = (None if parent is None else
                         sum(_bits_differ(x, y) for x, y in zip(got, parent)))
            rec_b = c_rec[label][label_b] = dict(elements_differ=differ, max_abs_diff=err,
                                                 parent_elements_differ=vs_parent,
                                                 kernels_a_call=launched[label])
            said = []
            for mode in modes:
                each = times[label, mode]
                ms = sum(each) / len(each)
                part_ms = {part: sum(x[part] for x in parts[label, mode]) / len(each)
                           for part, _ in PARTS.get(case.kernel, ())}
                key = "ms" if mode == "warm" else f"{mode.replace('-', '_')}_ms"
                rec_b.update({key: ms, f"{key}_each": each, f"{key}_parts": part_ms})
                said.append(f"{mode} {ms:.5f} ({', '.join(f'{x:.5f}' for x in each)}"
                            + "".join(f"; {k} {v:.5f}" for k, v in part_ms.items()) + ")")
            print(f"sweep {case.name} {label_b} {label}: ms on the device {'; '.join(said)}; "
                  f"{launched[label]} kernels a call; elements differing from the built kernel "
                  f"{differ} (max |diff| {err:.3e}), from the parent {vs_parent}; two launches "
                  f"bitwise equal")


def _call_ms(kernels, reps: int) -> float:
    """Device ms of one call from ``profile_kernels``' record of ``reps``
    calls: per kernel name, the mean launch time times its launches a call
    (the profiler now and then drops one; the glue's elementwise kernels
    may share a name), summed."""
    return sum(t / k * round(k / reps) for t, k in kernels.values()) / 1e3


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

    # conv holds raw pointers: the tensors behind them live as long as the call.
    call.given = given
    return call


# The order study's shot sizes below 2^20: prefixes of the drawn rays,
# each a uniform sample of them.
ORDER_SIZES = (1 << 15, 1 << 16, 1 << 17, 1 << 18, 1 << 19)
# K1 and the order's kernels, by the names the profiler records.
ORDER_KERNELS = ("grid_shoot_kernel", "grid_shoot_order_keys", "grid_shoot_order_scan",
                 "grid_shoot_order_place")


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def order_variant(bits) -> Variant:
    """K1's built source with the order's key of ``bits`` = (b, c): its
    ``kOriginBits`` and ``kDirBits``."""
    from ..accel import voxel

    names = ("kOriginBits", "kDirBits")
    reps = tuple((f"constexpr int {k} = {old};", f"constexpr int {k} = {new};")
                 for k, old, new in zip(names, voxel.ORDER_BITS, bits))
    built = " (built)" if tuple(bits) == voxel.ORDER_BITS else ""
    return Variant(f"{bits[0]}:{bits[1]}{built}",
                   variant_source((build.CSRC / SPECS["k1"].source).read_text(), reps),
                   build.CSRC, build.NVCC_FLAGS)


def _ordering(lib, grid, rays):
    """A call of a built K1 variant that orders ``rays`` itself, its outputs
    and its order: ``(call -> (best_t, best_tri), GridOrder)``.  The
    scratch is made once: the order leaves its counts at zero."""
    from ..accel import voxel

    fns, params, _ = lib
    cap = torch.zeros(2, dtype=torch.int32)
    if fns["hare_grid_shoot_capacity"](0, cap.data_ptr(), None) != 0:
        raise RuntimeError("hare_grid_shoot_capacity failed")
    fixed, n, dev = int(cap[1]), rays.origin.shape[0], rays.origin.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    i = torch.empty(n, dtype=torch.int32, device=dev)
    scratch = torch.zeros(fixed + 3 * n, dtype=torch.int32, device=dev)
    given = dict(zip(SPECS["k1"].args, voxel.grid_shoot_args(rays, grid, t, i, order=scratch)))
    given.update(counter=torch.zeros(2, dtype=torch.int32, device=dev),
                 stream=torch.cuda.current_stream().cuda_stream)
    call = _caller(fns[SPECS["k1"].entry], params, given)

    def run():
        call()
        return t, i

    return run, voxel.GridOrder(scratch[fixed:fixed + n], scratch[fixed + 2 * n:fixed + 3 * n])


def _sorted_rays(rays, grid, bits):
    """The rays sorted by the order's key (its plain version and a stable
    ``torch.sort``: the sweep's ceiling, with no cost of ordering) and the
    permutation."""
    from ..accel import voxel

    _, perm = voxel.grid_order_plain(rays, grid, bits)
    perm = perm.long()
    return type(rays)(*(x[perm] for x in rays)), perm


def check_order(name, rays, grid, got, bits=None) -> None:
    """K1's order ``got`` (a ``voxel.GridOrder``) of ``rays`` against its
    plain version with ``bits`` (None: the built ones): the same keys to
    the bit, a permutation, the keys non-decreasing along it."""
    from ..accel import voxel

    bits = voxel.ORDER_BITS if bits is None else bits
    keys, order = got
    n = keys.numel()
    plain = voxel.grid_order_keys_plain(rays, grid, bits)
    seen = torch.zeros(n, dtype=torch.int32, device=keys.device)
    seen.index_add_(0, order.long(), torch.ones_like(order))
    along = keys[order.long()]
    if not (torch.equal(keys, plain) and bool((seen == 1).all())
            and bool((along[1:] >= along[:-1]).all())):
        raise AssertionError(f"{name}: the kernels' order {bits} differs from its plain version")


def order_study(dev, bits_list, reps: int) -> dict:
    """K1 on each bounce's rays in drawn order against the same rays sorted
    by the order's key ("sorted": the ceiling, no cost of ordering) and
    against K1 built with that key ordering them itself ("order": its three
    kernels included; :func:`order_variant`), for each ``(b, c)`` of
    ``bits_list``; on config 5 (2 bounces of 2^20 rays, 256^3 tables beyond
    L2) and on the bench scene at 2^20 rays (3 bounces; its tables fit in
    L2), then on the first ``ORDER_SIZES`` rays of each with the first
    bits.  Every shoot is checked bit-equal to the drawn one ray by ray,
    and each variant's order against its plain version.  Times are ms a
    call by CUDA events, A B ... B A (over ``reps`` calls each; a profiler
    drops its records after many windows in one process), and each order
    kernel's device ms from one profiled window a case and bits."""
    from ..accel import voxel
    from . import configs

    resident, _ = voxel.card_capacity(dev)
    rec = {"card": _card(), "resident_rays": resident, "cases": {}}
    print(f"sweep order [{rec['card']}]: K1 runs {resident} rays at once")
    libs = {}

    def timed(name, grid, r, bits_here):
        def drawn(rays):
            return voxel._grid_shoot_card(rays, grid, ordered=False)[:2]

        base = drawn(r)
        runs = {"drawn": lambda: drawn(r)}
        for bits in bits_here:
            label = order_variant(bits).label
            rs, perm = _sorted_rays(r, grid, bits)
            own, got = _ordering(libs[label], grid, r)
            for out, at in ((drawn(rs), perm), (own(), None)):
                for x, y in zip(out, base):
                    y = y if at is None else y[at]
                    if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
                        raise AssertionError(f"{name}: {label} hits otherwise")
            check_order(name, r, grid, got, bits)
            runs[f"{label} sorted"] = lambda rs=rs: drawn(rs)
            runs[f"{label} order"] = own
        order = list(runs)
        times = {k: [] for k in order}
        for k in order + order[::-1]:
            times[k].append(seconds_per_call(runs[k], dev, reps) * 1e3)
        out = {k: sum(v) / len(v) for k, v in times.items()}
        parts = {}
        for k in order:
            if k.endswith(" order"):
                try:
                    got = profile_kernels(runs[k], reps)
                except RuntimeError:  # the profiler recorded nothing
                    continue
                parts[k] = {tag: sum(t / n for name, (t, n) in got.items() if tag in name) / 1e3
                            for tag in ORDER_KERNELS}
        print(f"sweep order {name} ({r.origin.shape[0]} rays): " + "; ".join(
            f"{k} {ms:.4f} ms ({', '.join(f'{x:.4f}' for x in times[k])}; "
            f"{ms / out['drawn'] - 1:+.1%})" for k, ms in out.items())
            + "; device ms by kernel: " + "; ".join(
                f"{k} " + ", ".join(f"{n} {ms:.4f}" for n, ms in v.items())
                for k, v in parts.items()))
        rec["cases"][name] = dict(ms=out, each=times, kernels_ms=parts, n=r.origin.shape[0])

    def study(label, grid, batches):
        for b, r in enumerate(batches, 1):
            timed(f"{label} bounce {b}", grid, r, bits_list)
        for b, r in enumerate(batches, 1):
            for m in ORDER_SIZES:
                timed(f"{label} bounce {b} first {m}", grid, type(r)(*(x[:m] for x in r)),
                      bits_list[:1])

    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        libs.update(_build(SPECS["k1"].entry, [order_variant(b) for b in bits_list], Path(tmp),
                           "order", others=("hare_grid_shoot_capacity",)))
        cfg = configs.config5_setup(dev)
        study("config 5", cfg.partition.struct,
              bounce_rays(cfg.partition, cfg.rays, cfg.absorption, cfg.n_bounces))
        del cfg
        _, sp, rays, a = bench_setup(dev, 1 << 20)
        study("bench 2^20", sp.struct, bounce_rays(sp, rays, a))
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", default="k1,b1,b2,b3,a3,k3,k2,hb,gs",
                    help="comma-separated, of " + ", ".join(SPECS))
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout whose kernels are candidates too")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--order", default="",
                    help="b:c,... : time K1 ordering its rays by keys of these bits, and on "
                         "rays sorted by them, instead of the candidates")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the sweep times the card: torch.cuda.is_available() is False")
    if args.order:
        bits = [tuple(int(x) for x in b.split(":")) for b in args.order.split(",")]
        build.library()
        rec = order_study(torch.device("cuda"), bits, args.reps)
        print(json.dumps({"kernel_sweep_order": rec}))
        return rec
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
                text = (parent / spec.source).read_text()
                older = f'extern "C" int {spec.entry}(' not in text and spec.older
                variants.insert(0, Variant("parent", text, parent, _nvcc_flags(args.parent),
                                           older or ""))
            built_libs = _build(spec.entry, variants, Path(tmp), key, leave_out_failed=True,
                                others=spec.others)
            for torch_key, label, fn in (("hb", GLUE, _glue), ("gs", YARDSTICK, _yardstick)):
                if key == torch_key:
                    built_libs[label] = (fn, None, [])
                    variants.append(Variant(label, "", build.CSRC, build.NVCC_FLAGS))
            libs[key] = (built_libs, [v for v in variants if v.label in built_libs])
            for label, (_, _, report) in built_libs.items():
                print(f"sweep ptxas {key} {label}: " + " | ".join(report))

        calls = [k for k in kernels if k in CALL_KERNELS]
        for case in _call_cases(dev, calls) if calls else []:
            _run_call_case(case, *libs[case.kernel], args.reps, rec)
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
                    fns, params, _ = built_libs[v.label]
                    t = torch.empty(n, dtype=torch.float32, device=dev)
                    i = torch.empty(n, dtype=torch.int32, device=dev)
                    s = torch.empty(n, dtype=torch.int32, device=dev) if walks else None
                    e = torch.zeros(1, dtype=torch.int32, device=dev)
                    given = dict(zip(spec.args, case.args(r, t, i, s, e)))
                    given.update(counter=torch.zeros(2, dtype=torch.int32, device=dev),
                                 stream=stream)
                    call = _caller(fns[spec.entry], params, given)
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
