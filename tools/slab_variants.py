#!/usr/bin/env python3
"""Build variants of the port's kernel sources and hold each beside the
committed kernel on one CUDA card.

    python3 tools/slab_variants.py [--parent DIR] [--kernels LIST]

Each variant is a committed source of ``src/repro_torch/csrc/`` with a few
lines edited (``VARIANTS``); ``--parent`` adds the sources of another
checkout (an unpacked earlier commit) under the name ``parent``.  All are
compiled in parallel into ``build/slab_variants/`` and loaded with ctypes.
``--kernels`` picks among ``sweep``, ``count`` (``slab_sweep.cu``,
``slab_intersect.cu``), ``probe``, ``commit`` (``slab_update.cu``),
``chain`` (``slab_compact.cu``), ``hits`` (the membership probe of
``slab_intersect.cu``), ``bag`` (``embedding_bag.cu``) and ``contrib``
(kernel 4, ``slab_pagerank.cu``); the default is all eight.  ``serve``
(with ``--parent``) also runs the serve of
``chip_smoke.SERVE_ARGS`` end to end from this checkout and from the
parent's, each in its own process, in turns (parent, committed, committed,
parent), and prints each request's latency.

Sweep and count run on the serve's graph (RMAT scale 20, 2**24 generated
edges, seed 0, deduplicated): its forward view unhashed, as the serve sweeps
it, and its symmetric view hashed, as the triangle phase counts on it.  For
each variant the script prints:

* the sweep's device time for ``sum`` (no frontier; PageRank's sweep) and
  ``min_plus`` with a random 30% frontier (BFS's), and the CSR
  ``torch.mv`` of the same sums beside them;
* the count's device time on the static count's busiest chunk (8,192
  edges, the most (edge, bucket) items), on the active items, with the L2
  flushed before each call; the parent also on the dense (edge, bucket)
  layout its ops built;
* the static count (``triangles_static``) end to end, host clock, with the
  variant's library in the engine (the parent with its dense layout).

Kernel 4 (``contrib``) runs on the same graph's transpose (unhashed, as
PageRank sweeps it) with random contributions: each variant's device time,
beside kernel 3's committed ``sum`` on the same pool (which reads only the
filled lanes), the CSR ``torch.mv``, the whole-row bound, the committed
op per call (``op_ms``) and its owner mask reduced as bools and as int64
words.  A parent
checkout without ``slab_pagerank.cu`` adds no ``contrib`` build.

Probe, commit and chain walk run on the inputs the serve hands them
(``chip_smoke.capture_serve_inputs``: the first probe and commit of each
batch size and the first compaction's chain walk, forward view).  The probe
and chain walk also run on a copy of each pool whose overflow rows are
relabelled by a seeded permutation (``chip_smoke.relabelled``), where almost
no link is ``r -> r + 1``: the device time of each variant, L2 flushed
before each call.  The commit is timed on each plan and on the same plan
with every entry parked (``parked_ms``: no store, no atomic), beside the
plan's degree runs (``chip_smoke.degree_runs``).  These variants are called
through their C entry points directly, since the parent's may take other
arguments than the committed wrappers pass.

The membership probe (``hits``) runs on 5,120 queries of the hashed
symmetric view, half of them its edges, with each query's bucket chain as
its candidate rows, as the triangle phase calls it; on the same queries
with 8 random rows each; and on 256 of them with 8 random rows each (no
caller sends so few: it shows where ``grouped`` gains): each variant's
device time, L2 flushed before each call and warm.  ``grouped`` is the
design tried and not kept (every row of a query read before one ballot).

The bag runs on ``chip_smoke.bag_inputs`` (MIND's 2**21 x 64 table, float32
and bfloat16; B = 512 and 65,536): each variant with the L2 warm and
flushed.  Beside them, a plain gather (``GATHER_SRC``) reads the rows of the
B = 65,536 bags' valid slots and nothing else, warm and flushed: the rate
the card gathers those rows at.

Every variant is checked against the plain version first (the sum within
``chip_smoke.SUM_RTOL``, the bag within ``chip_smoke.BAG_TOL``, all else
exactly).  Variants are timed in turns, forward then backward.  Exits
nonzero without a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "slab_variants"

#: the ``coop`` probe variant: a walk that passes kLongRows rows is queued
#: (a static queue, enough for the serve's batches) and finished by a
#: second launch, a block of 8 warps a queued walk: each warp loads the
#: window itself, takes rows warp, warp + 8, ... of the run, and the block
#: keeps the least (position, lane) hit
_COOP_DECLS = """constexpr int kLongRows = 64;
constexpr int kQueueCap = 1 << 17;
__device__ int g_long_n;
__device__ int4 g_long[kQueueCap];
"""
_COOP_HANDOFF = """    if (S - left >= kLongRows &&
        static_cast<unsigned>(cur) < static_cast<unsigned>(S) && left > 0) {
      int at = 0;
      if (t == 0) at = atomicAdd(&g_long_n, 1);
      at = __shfl_sync(0xffffffffu, at, 0);
      if (t == 0) g_long[at] = make_int4(q, cur, left, static_cast<int>(d));
      return;
    }
"""
_COOP_KERNEL = """\
__global__ void long_probe_kernel(const uint32_t* __restrict__ keys,
                                  const int32_t* __restrict__ next_slab,
                                  uint8_t* __restrict__ found,
                                  int32_t* __restrict__ slab_out,
                                  int32_t* __restrict__ lane_out, int S) {
  __shared__ int best;
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const uint4* rows = reinterpret_cast<const uint4*>(keys);
  const int n = g_long_n;
  for (int i = blockIdx.x; i < n; i += gridDim.x) {
    const int4 e = g_long[i];
    int cur = e.y, left = e.z;
    const uint32_t d = static_cast<uint32_t>(e.w);
    int s = -1, l = -1;
    while (static_cast<unsigned>(cur) < static_cast<unsigned>(S) && left > 0) {
      const int w = cur + t;
      const int nw = w < S ? next_slab[w] : -1;
      if (threadIdx.x == 0) best = 0x7fffffff;
      __syncthreads();
      const unsigned linked =
          __ballot_sync(0xffffffffu, nw == w + 1 && w + 1 < S);
      const int run = min(linked == 0xffffffffu ? 31 : __ffs(~linked) - 1,
                          left - 1);
      uint4 r[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (warp + 8 * k <= run)
          r[k] = rows[static_cast<size_t>(cur + warp + 8 * k) * 32 + t];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int lane;
        if (warp + 8 * k <= run && row_hit(r[k], d, lane)) {
          if (t == 0) atomicMin(&best, (warp + 8 * k) * 128 + lane);
          break;
        }
      }
      __syncthreads();
      const int b = best;
      if (b != 0x7fffffff) {
        s = cur + b / 128;
        l = b % 128;
        break;
      }
      left -= run + 1;
      cur = __shfl_sync(0xffffffffu, nw, run);
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      found[e.x] = static_cast<uint8_t>(s >= 0);
      slab_out[e.x] = s;
      lane_out[e.x] = l;
    }
    __syncthreads();
  }
}

"""
_COOP_RESET = """    void* long_n = nullptr;
    cudaGetSymbolAddress(&long_n, g_long_n);
    cudaMemsetAsync(long_n, 0, sizeof(int), static_cast<cudaStream_t>(stream));
"""
_COOP_LAUNCH = """\
    long_probe_kernel<<<132 * 4, 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(keys),
        static_cast<const int32_t*>(next_slab), static_cast<uint8_t*>(found),
        static_cast<int32_t*>(slab), static_cast<int32_t*>(lane), S);
"""
#: the ``ownwarp`` chain-walk variant: the warp takes each of its threads'
#: long chains in turn, and nothing is queued
_OWN_WARP = """  for (unsigned own = __ballot_sync(0xffffffffu, going); own;
       own &= own - 1) {
    const int leader = __ffs(own) - 1;
    walk_chain(next_slab, live_count, base_rank, bucket_of, chain_pos, counts,
               __shfl_sync(0xffffffffu, b, leader),
               __shfl_sync(0xffffffffu, cur, leader),
               __shfl_sync(0xffffffffu, run, leader),
               __shfl_sync(0xffffffffu, pos, leader), S);
  }
  const unsigned want = 0u;
"""

#: (kernel, name) -> (what it changes, [(committed text, replacement)]),
#: applied to the kernel's source (``SOURCES``)
VARIANTS = {
    ("sweep", "committed"): ("the source as committed", []),
    ("sweep", "eager"): (
        "the first step's keys read beside the owner, not after it",
        [("  bool open = row < S && owner[row] >= 0;\n",
          "  const uint4 kv0 = row < S ? reinterpret_cast<const uint4*>(\n"
          "      keys + static_cast<size_t>(row) * kSlabWidth)[j]\n"
          "      : make_uint4(0, 0, 0, 0);\n"
          "  bool open = row < S && owner[row] >= 0;\n"),
         ("      const uint4 kv = k4[s * kGroup];\n",
          "      const uint4 kv = s == 0 ? kv0 : k4[s * kGroup];\n")]),
    ("sweep", "group1"): (
        "a thread a row: 16 B steps, 32 rows a warp",
        [("constexpr int kGroup = 4;", "constexpr int kGroup = 1;")]),
    ("sweep", "group2"): (
        "2 threads a row: 32 B steps (one sector), 16 rows a warp",
        [("constexpr int kGroup = 4;", "constexpr int kGroup = 2;")]),
    ("sweep", "group8"): (
        "8 threads a row: 128 B steps, four rows a warp",
        [("constexpr int kGroup = 4;", "constexpr int kGroup = 8;")]),
    ("sweep", "group16"): (
        "16 threads a row: 256 B steps, two rows a warp",
        [("constexpr int kGroup = 4;", "constexpr int kGroup = 16;")]),
    ("sweep", "group32"): (
        "a warp a row, reading its 512 B up to the first EMPTY lane",
        [("constexpr int kGroup = 4;", "constexpr int kGroup = 32;")]),
    ("contrib", "committed"): ("the source as committed", []),
    ("contrib", "group4"): (
        "4 threads a row: 64 B steps, eight uint4 a thread, 8 rows a warp",
        [("constexpr int kGroup = 8;", "constexpr int kGroup = 4;")]),
    ("contrib", "group16"): (
        "16 threads a row: 256 B steps, two uint4 a thread, 2 rows a warp",
        [("constexpr int kGroup = 8;", "constexpr int kGroup = 16;")]),
    ("contrib", "group32"): (
        "a warp a row: the row's 512 B in one step, one uint4 a thread",
        [("constexpr int kGroup = 8;", "constexpr int kGroup = 32;")]),
    ("contrib", "rows1"): (
        "one row a group (four a warp)",
        [("constexpr int kRows = 4;", "constexpr int kRows = 1;")]),
    ("contrib", "rows2"): (
        "two rows a group (eight a warp)",
        [("constexpr int kRows = 4;", "constexpr int kRows = 2;")]),
    ("contrib", "rows8"): (
        "eight rows a group, all eight rows' keys loaded before any gather",
        [("constexpr int kRows = 4;", "constexpr int kRows = 8;")]),
    ("contrib", "threads512"): (
        "blocks of 16 warps",
        [("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")]),
    ("contrib", "cached"): (
        "the key loads through L1 and L2 as usual, not evict-first",
        [("__ldcs(k4 + q * kGroup)", "k4[q * kGroup]")]),
    ("count", "committed"): ("the source as committed", []),
    ("count", "quads1"): (
        "a probe thread loads one uint4 (16 B) a step",
        [("constexpr int kProbeQuads = 4;", "constexpr int kProbeQuads = 1;")]),
    ("count", "quads2"): (
        "a probe thread loads two uint4 (32 B, one sector) a step",
        [("constexpr int kProbeQuads = 4;", "constexpr int kProbeQuads = 2;")]),
    ("count", "quads8"): (
        "a probe thread loads eight uint4 (128 B) a step",
        [("constexpr int kProbeQuads = 4;", "constexpr int kProbeQuads = 8;")]),
    ("count", "group4"): (
        "4-thread probes (64 B steps, eight probes a warp)",
        [("constexpr int kProbeGroup = 1;", "constexpr int kProbeGroup = 4;")]),
    ("count", "group8"): (
        "8-thread probes (128 B steps, four probes a warp)",
        [("constexpr int kProbeGroup = 1;", "constexpr int kProbeGroup = 8;")]),
    ("probe", "committed"): ("the source as committed", []),
    ("probe", "pointer"): (
        "the chain pointer issued with the row, no run followed",
        [("    const int nw = w < S ? next_slab[w] : -1;\n",
          "    const int nw = t == 0 ? next_slab[cur] : -1;\n"),
         ("    const unsigned linked =\n"
          "        __ballot_sync(0xffffffffu, nw == w + 1 && w + 1 < S);\n",
          "    const unsigned linked = 0u;\n")]),
    ("probe", "rows1"): (
        "a run followed one row a step",
        [("constexpr int kRunRows = 8;", "constexpr int kRunRows = 1;")]),
    ("probe", "rows4"): (
        "a run followed four rows a step",
        [("constexpr int kRunRows = 8;", "constexpr int kRunRows = 4;")]),
    ("probe", "rows8occ"): (
        "eight rows a step, registers held to six blocks an SM",
        [("__global__ void probe_kernel(",
          "__global__ void __launch_bounds__(256, 6) probe_kernel(")]),
    ("probe", "rows16"): (
        "a run followed sixteen rows a step",
        [("constexpr int kRunRows = 8;", "constexpr int kRunRows = 16;")]),
    ("probe", "coop"): (
        "a walk past 64 rows handed to a block of 8 warps (second launch), "
        "its warps taking alternate rows of each run",
        [("constexpr int kRunRows = 8;\n", "constexpr int kRunRows = 8;\n"
          + _COOP_DECLS),
         ("    left -= run + 1;\n"
          "    cur = __shfl_sync(0xffffffffu, nw, run);\n  }\n",
          "    left -= run + 1;\n"
          "    cur = __shfl_sync(0xffffffffu, nw, run);\n" + _COOP_HANDOFF
          + "  }\n"),
         ("__device__ __forceinline__ void add_degree(",
          _COOP_KERNEL + "__device__ __forceinline__ void add_degree("),
         ("    probe_kernel<<<blocks,", _COOP_RESET + "    probe_kernel<<<blocks,"),
         ("        static_cast<int32_t*>(lane), S, B);\n",
          "        static_cast<int32_t*>(lane), S, B);\n" + _COOP_LAUNCH)]),
    ("chain", "committed"): ("the source as committed", []),
    ("chain", "hops1"): (
        "a thread walks one row (its head) before its chain is queued",
        [("constexpr int kThreadHops = 2;", "constexpr int kThreadHops = 1;")]),
    ("chain", "hops4"): (
        "a thread walks four rows before its chain is queued",
        [("constexpr int kThreadHops = 2;", "constexpr int kThreadHops = 4;")]),
    ("chain", "ownwarp"): (
        "no queue: each warp walks its own threads' long chains in turn",
        [("  const unsigned want = __ballot_sync(0xffffffffu, going);\n",
          _OWN_WARP),
         ("    long_chain_kernel<<<", "    if (false) long_chain_kernel<<<")]),
}

#: the ``stride`` commit variants: E entries a thread, each plan array read
#: with one load of E words where every array is aligned to it, the runs a
#: thread holds summed before the warp's scan, on a grid no larger than the
#: card holds at once that strides over B
_STRIDE_KERNEL = r"""constexpr int kStrideThreads = 128;

template <int E>
__device__ __forceinline__ void load_entries(const int32_t* __restrict__ p,
                                             int i0, int B, bool vec,
                                             int fill, int (&o)[E]) {
  if (vec && i0 + E <= B) {
    if constexpr (E == 4) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(p + i0));
      o[0] = v.x;
      o[1] = v.y;
      o[2] = v.z;
      o[3] = v.w;
      return;
    } else if constexpr (E == 2) {
      const int2 v = __ldg(reinterpret_cast<const int2*>(p + i0));
      o[0] = v.x;
      o[1] = v.y;
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) o[e] = i0 + e < B ? __ldg(p + i0 + e) : fill;
}

template <int E>
__global__ void __launch_bounds__(kStrideThreads)
    commit_stride_kernel(uint32_t* __restrict__ keys,
                         int32_t* __restrict__ degree,
                         float* __restrict__ weights,
                         const int32_t* __restrict__ e_slab,
                         const int32_t* __restrict__ e_lane,
                         const uint32_t* __restrict__ vals,
                         const int32_t* __restrict__ deg_idx,
                         const int32_t* __restrict__ deg_delta,
                         const float* __restrict__ wvals, int S, int V,
                         int B) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(e_slab) |
                        reinterpret_cast<uintptr_t>(e_lane) |
                        reinterpret_cast<uintptr_t>(vals) |
                        reinterpret_cast<uintptr_t>(deg_idx) |
                        reinterpret_cast<uintptr_t>(deg_delta) |
                        reinterpret_cast<uintptr_t>(wvals);
  const bool vec = any % (E * sizeof(int32_t)) == 0;
  const int lane = threadIdx.x & 31;
  const int groups = (B + E - 1) / E;
  for (int base = blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       base < groups; base += gridDim.x * blockDim.x) {
    const int i0 = (base + lane) * E;
    int slab[E], ln[E], val[E], key[E], dd[E], wv[E];
    load_entries<E>(e_slab, i0, B, vec, -1, slab);
    load_entries<E>(e_lane, i0, B, vec, 0, ln);
    load_entries<E>(reinterpret_cast<const int32_t*>(vals), i0, B, vec, 0,
                    val);
    load_entries<E>(deg_idx, i0, B, vec, -1, key);
    load_entries<E>(deg_delta, i0, B, vec, 0, dd);
    if (weights != nullptr && wvals != nullptr)
      load_entries<E>(reinterpret_cast<const int32_t*>(wvals), i0, B, vec, 0,
                      wv);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (static_cast<unsigned>(slab[e]) < static_cast<unsigned>(S)) {
        const size_t at = static_cast<size_t>(slab[e]) * kSlabWidth + ln[e];
        keys[at] = static_cast<uint32_t>(val[e]);
        if (weights != nullptr)
          weights[at] = wvals != nullptr ? __int_as_float(wv[e]) : 0.0f;
      }
      if (static_cast<unsigned>(key[e]) >= static_cast<unsigned>(V))
        key[e] = -1;
    }
    int tail = key[0], sum = dd[0], head_sum = 0;
    bool whole = true;
#pragma unroll
    for (int e = 1; e < E; ++e) {
      if (key[e] == tail) {
        sum += dd[e];
        continue;
      }
      if (whole)
        head_sum = sum;
      else
        add_degree(degree, tail, sum);
      whole = false;
      tail = key[e];
      sum = dd[e];
    }
    const int head = key[0];
    const int prev_tail = __shfl_up_sync(0xffffffffu, tail, 1);
    const bool cont = lane > 0 && prev_tail == head;
    bool starts = !(whole && cont);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, sum, off);
      const int up_starts =
          __shfl_up_sync(0xffffffffu, static_cast<int>(starts), off);
      if (lane >= off) {
        if (!starts) sum += up;
        starts = starts || up_starts != 0;
      }
    }
    const int before = __shfl_up_sync(0xffffffffu, sum, 1);
    if (!whole) add_degree(degree, head, head_sum + (cont ? before : 0));
    const int next_head = __shfl_down_sync(0xffffffffu, head, 1);
    if (lane == 31 || next_head != tail) add_degree(degree, tail, sum);
  }
}

"""
_STRIDE_LAUNCH = """    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, commit_stride_kernel<{E}>, kStrideThreads, 0);
    const int want =
        ((B + {E} - 1) / {E} + kStrideThreads - 1) / kStrideThreads;
    const int held = sms * (per_sm > 0 ? per_sm : 1);
    commit_stride_kernel<{E}><<<want < held ? want : held, kStrideThreads,
                    0, static_cast<cudaStream_t>(stream)>>>(
"""
_COMMIT_DEF = ("__global__ void __launch_bounds__(kCommitThreads)\n"
               "    commit_kernel(")
_COMMIT_LAUNCH = ("    commit_kernel<<<(B + kCommitThreads - 1) / "
                  "kCommitThreads, kCommitThreads,\n"
                  "                    0, static_cast<cudaStream_t>(stream)>>>(\n")
_SCAN = "  // segmented inclusive scan of the deltas over the warp's runs of one key\n"
_PER_LANE = (_SCAN, "  add_degree(degree, key, sum);\n  return;\n" + _SCAN)

_NO_PREFETCH = ("""#pragma unroll
        for (int t = 0; t < kStage / 32; ++t) {
          my[t] = next_idx[t];
          mw[t] = next_w[t];
        }
        // the next step: this bag's next stage, its next chunk's first
        // stage, or the team's next bag's first stage
        const bool last = st + 1 == stages && c + 1 == chunks;
        load_stage(indices, weights, last ? bag + step : bag,
                   st + 1 < stages ? lo + (st + 1) * kStage : lo, hi, B, L,
                   lane, next_idx, next_w);
""", """        load_stage(indices, weights, bag, lo + st * kStage, hi, B, L, lane,
                   my, mw);
""")

#: a design of the membership probe tried and not kept: G lanes a query
#: (8, 16 or 32 from C), its row ids in one load, every row's quads issued
#: before one ballot
_HITS_GROUPED = [("""__global__ void probe_hits_kernel(const uint32_t* __restrict__ ws,
                                  const int32_t* __restrict__ rows,
                                  const uint32_t* __restrict__ keys,
                                  uint8_t* __restrict__ out, int Q, int C,
                                  int S) {
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int t = threadIdx.x & 31;
  if (q >= Q) return;  // uniform per warp
  const uint32_t w = ws[q];
  const int32_t* my_rows = rows + static_cast<size_t>(q) * C;
  int hit = 0;
  for (int c = 0; c < C && !hit; ++c) {
    const int r = my_rows[c];
    if (static_cast<unsigned>(r) >= static_cast<unsigned>(S)) continue;
    hit = __ballot_sync(kFull, quad_has(row_quad(keys, r, t), w)) != 0;
  }
  if (t == 0) out[q] = static_cast<uint8_t>(hit);
}
""", """template <int G>
__global__ void probe_hits_kernel(const uint32_t* __restrict__ ws,
                                  const int32_t* __restrict__ rows,
                                  const uint32_t* __restrict__ keys,
                                  uint8_t* __restrict__ out, int Q, int C,
                                  int S) {
  constexpr int kQuads = 32 / G;  // quads of a row a lane reads
  constexpr int kRows = G / 4;    // rows a step: 8 loads in flight a lane
  const int lane = threadIdx.x & 31, j = lane % G, lead = lane - j;
  const int64_t qq =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const bool active = qq < Q;
  const int64_t q = active ? qq : 0;
  const uint32_t w = active ? ws[q] : 0u;
  const int32_t* my_rows = rows + q * C;
  const unsigned gmask = (G == 32 ? kFull : (1u << G) - 1) << lead;
  bool hit = false, done = false;
  // every bound below is uniform over the warp, so are the shuffles
  for (int c0 = 0; c0 < C && !done; c0 += G) {
    const int n = min(G, C - c0);
    const int id = active && j < n ? my_rows[c0 + j] : -1;
    for (int r0 = 0; r0 < n; r0 += kRows) {
      uint4 kv[kRows][kQuads];
      bool ok[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = __shfl_sync(kFull, id, lead + min(r0 + r, G - 1));
        ok[r] = r0 + r < n &&
                static_cast<unsigned>(row) < static_cast<unsigned>(S);
        if (ok[r]) {
#pragma unroll
          for (int k = 0; k < kQuads; ++k)
            kv[r][k] = row_quad(keys, row, j + G * k);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (!ok[r]) continue;
#pragma unroll
        for (int k = 0; k < kQuads; ++k) hit |= quad_has(kv[r][k], w);
      }
      const unsigned found = __ballot_sync(kFull, hit);
      done = __all_sync(kFull, !active || (found & gmask) != 0);
      if (done) break;
    }
  }
  hit = (__ballot_sync(kFull, hit) & gmask) != 0;
  if (active && j == 0) out[q] = static_cast<uint8_t>(hit);
}

template <int G>
void launch_probe_hits(const void* ws, const void* rows, const void* keys,
                       void* out, int Q, int C, int S, cudaStream_t stream) {
  constexpr int kQueriesPerBlock = kWarpsPerBlock * 32 / G;
  const int blocks = static_cast<int>(
      (static_cast<int64_t>(Q) + kQueriesPerBlock - 1) / kQueriesPerBlock);
  probe_hits_kernel<G><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const uint32_t*>(ws), static_cast<const int32_t*>(rows),
      static_cast<const uint32_t*>(keys), static_cast<uint8_t*>(out), Q, C,
      S);
}
"""),
                 ("""  if (Q > 0) {
    const int blocks = (Q + kWarpsPerBlock - 1) / kWarpsPerBlock;
    probe_hits_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(ws), static_cast<const int32_t*>(rows),
        static_cast<const uint32_t*>(keys), static_cast<uint8_t*>(out), Q, C,
        S);
  }
""", """  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q > 0) {
    // lanes a query: the fewest that read a query's rows in one step
    if (C <= 2)
      launch_probe_hits<8>(ws, rows, keys, out, Q, C, S, s);
    else if (C <= 4)
      launch_probe_hits<16>(ws, rows, keys, out, Q, C, S, s);
    else
      launch_probe_hits<32>(ws, rows, keys, out, Q, C, S, s);
  }
""")]
_HITS_ONE_G = ("""    if (C <= 2)
      launch_probe_hits<8>(ws, rows, keys, out, Q, C, S, s);
    else if (C <= 4)
      launch_probe_hits<16>(ws, rows, keys, out, Q, C, S, s);
    else
      launch_probe_hits<32>(ws, rows, keys, out, Q, C, S, s);
""", """    launch_probe_hits<32>(ws, rows, keys, out, Q, C, S, s);
""")

VARIANTS.update({
    ("hits", "committed"): ("the source as committed", []),
    ("hits", "grouped"): (
        "G lanes a query, every row read before one ballot",
        _HITS_GROUPED),
    ("hits", "grouped_warp"): (
        "grouped, but 32 lanes a query whatever C",
        _HITS_GROUPED + [_HITS_ONE_G]),
    ("hits", "ids_only"): (
        "(not the function) the row ids and keys read, no row",
        [("    hit = __ballot_sync(kFull, quad_has(row_quad(keys, r, t), w)) "
          "!= 0;\n",
          "    hit = __ballot_sync(kFull, static_cast<uint32_t>(r) == w) != "
          "0;\n")]),
    ("commit", "committed"): ("the source as committed", []),
    ("commit", "perlane"): (
        "an atomic a live entry, no run sums",
        [_PER_LANE]),
    **{("commit", f"threads{n}"): (
        f"{n} threads a block",
        [("constexpr int kCommitThreads = 128;",
          f"constexpr int kCommitThreads = {n};")]) for n in (64, 256)},
    ("commit", "dependent"): (
        "an entry's deg_idx and delta loaded after its stores",
        [("    key = __ldg(deg_idx + i);\n    sum = __ldg(deg_delta + i);\n", ""),
         ("  // parked (outside [0, V)) is -1, which adds nothing\n",
          "  if (i < B) {\n    key = deg_idx[i];\n    sum = deg_delta[i];\n  }\n"
          "  // parked (outside [0, V)) is -1, which adds nothing\n")]),
    ("commit", "threads256perlane"): (
        "256 threads a block and an atomic a live entry (PR 17's form)",
        [("constexpr int kCommitThreads = 128;",
          "constexpr int kCommitThreads = 256;"), _PER_LANE]),
    **{("commit", f"stride{n}"): (
        f"{n} entr{'y' if n == 1 else 'ies'} a thread "
        f"(one {4 * n}-byte load an array), run sums, on a grid the card "
        "holds at once striding over B",
        [(_COMMIT_DEF, _STRIDE_KERNEL + _COMMIT_DEF),
         (_COMMIT_LAUNCH, _STRIDE_LAUNCH.replace("{E}", str(n)))])
       for n in (1, 2, 4)},
    ("bag", "committed"): ("the source as committed", []),
    **{("bag", f"rows{n}"): (
        f"{n} rows in flight a warp",
        [("constexpr int kRowsInFlight = 4;",
          f"constexpr int kRowsInFlight = {n};")]) for n in (2, 8, 16)},
    ("bag", "f32occ4"): (
        "float32 registers held to 4 blocks an SM (64, as bfloat16)",
        [("constexpr int kMinBlocksF32 = 5;",
          "constexpr int kMinBlocksF32 = 4;")]),
    ("bag", "bf16occ5"): (
        "bfloat16 registers held to 5 blocks an SM (48, as float32)",
        [("constexpr int kMinBlocksBf16 = 4;",
          "constexpr int kMinBlocksBf16 = 5;")]),
    **{("bag", f"occ{b}"): (
        f"registers held to {b} blocks an SM in both dtypes" if b > 1
        else "registers as ptxas chooses",
        [("constexpr int kMinBlocksF32 = 5;",
          f"constexpr int kMinBlocksF32 = {b};"),
         ("constexpr int kMinBlocksBf16 = 4;",
          f"constexpr int kMinBlocksBf16 = {b};")]) for b in (1, 6)},
    ("bag", "stage32"): (
        "32 slots a stage (one index a lane)",
        [("constexpr int kStage = 64;", "constexpr int kStage = 32;")]),
    ("bag", "nosplit"): (
        "a warp a bag at every B (no block split)",
        [("  const int split = bag_split(B, L, sms);",
          "  const int split = 1;")]),
    ("bag", "noprefetch"): (
        "a step loads its own indices and weights (none loaded ahead)",
        [_NO_PREFETCH]),
    ("bag", "waves"): (
        "a block for every kWarps / split bags (no walk over bags)",
        [("  const int blocks = want < held ? want : held;",
          "  const int blocks = want;")]),
    ("bag", "waves_noprefetch"): (
        "a block for every kWarps / split bags, nothing loaded ahead",
        [("  const int blocks = want < held ? want : held;",
          "  const int blocks = want;"),
         _NO_PREFETCH]),
})

#: the ``gather`` reading: the rows of the bags' valid slots, in order, each
#: read with 16-byte loads by a group of lanes, 8 loads a lane in flight,
#: folded into one word a thread so that no load is dropped; nothing else
GATHER_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kUnroll = 8;

__global__ void gather_kernel(const int32_t* __restrict__ flat, int n,
                              const uint4* __restrict__ table, int Q, int G,
                              uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31, grp = lane / G, sub = lane % G;
  const int rows = 32 / G;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int warps = (gridDim.x * blockDim.x) >> 5;
  uint32_t acc = 0;
  for (int i0 = warp * rows * kUnroll; i0 < n; i0 += warps * rows * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * rows + grp;
      v[u] = i < n && sub < Q
                 ? __ldg(table + static_cast<size_t>(flat[i]) * Q + sub)
                 : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

extern "C" int row_gather(const void* flat, int n, const void* table,
                          int row_bytes, void* out, int blocks,
                          void* stream) {
  const int Q = row_bytes / 16;
  int G = 1;
  while (G < Q && G < 32) G *= 2;
  gather_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(flat), n, static_cast<const uint4*>(table),
      Q, G, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""

#: kernel -> source
SOURCES = {"sweep": "slab_sweep", "count": "slab_intersect",
           "hits": "slab_intersect", "probe": "slab_update",
           "chain": "slab_compact", "commit": "slab_update",
           "bag": "embedding_bag", "contrib": "slab_pagerank"}


def ptxas_summary(log: str) -> dict:
    """Registers and spill bytes of each kernel entry in a ``ptxas -v``
    log, keyed by the entry's name and template arguments."""
    out, entry = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = re.search(r"'([^']+)'", ln).group(1)
            short = re.search(r"\d+([a-z_]+_kernel)(I\w+?EE)?", name)
            entry = (short.group(1) + (short.group(2) or "")) if short \
                else name[-40:]
        elif "spill stores" in ln and entry is not None:
            spill = re.findall(r"(\d+) bytes spill", ln)
            out.setdefault(entry, {})["spill"] = [int(s) for s in spill]
        elif "registers" in ln and entry is not None:
            out.setdefault(entry, {})["regs"] = int(
                re.search(r"Used (\d+) registers", ln).group(1))
    return out


def build(parent, kernels):
    from repro_torch.kernels import runtime

    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for (kernel, name), (_, edits) in VARIANTS.items():
        if kernel not in kernels:
            continue
        text = (CSRC / f"{SOURCES[kernel]}.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{kernel}/{name}: edit no longer applies: "
                                 f"{old!r}")
            text = text.replace(old, new)
        path = OUT / f"{kernel}-{name}.cu"
        path.write_text(text)
        jobs[(kernel, name)] = path
    if parent is not None:
        for kernel in sorted(kernels & set(SOURCES)):
            path = Path(parent) / "src" / "repro_torch" / "csrc" \
                / f"{SOURCES[kernel]}.cu"
            if path.is_file():
                jobs[(kernel, "parent")] = path
    if "bag" in kernels:
        path = OUT / "row_gather.cu"
        path.write_text(GATHER_SRC)
        jobs[("gather", "rows")] = path
    procs = {}
    for key, path in jobs.items():
        so = OUT / f"lib{key[0]}-{key[1]}.so"
        procs[key] = (so, subprocess.Popen(
            [runtime.nvcc(), *runtime.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(so), str(path)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{key} failed to build:\n{log}")
        print(json.dumps({"build": f"{key[0]}/{key[1]}",
                          "ptxas": ptxas_summary(log)}), flush=True)
        libs[key] = ctypes.CDLL(str(so))
    return libs


_P, _I = ctypes.c_void_p, ctypes.c_int


def probe_entry(lib, parent: bool):
    """``(keys, next_slab, start, dst) -> (found, slab, lane)`` through a
    library's C entry point; the parent's takes no pool size."""
    import torch
    fn = lib.slab_probe
    fn.argtypes = [_P] * 7 + ([_I] if parent else [_I, _I]) + [_P]
    fn.restype = _I

    def run(keys, nxt, start, dst):
        B, S, dev = start.shape[0], keys.shape[0], keys.device
        found = torch.empty(B, dtype=torch.bool, device=dev)
        slab = torch.empty(B, dtype=torch.int32, device=dev)
        lane = torch.empty(B, dtype=torch.int32, device=dev)
        sizes = [B] if parent else [S, B]
        rc = fn(keys.data_ptr(), nxt.data_ptr(), start.data_ptr(),
                dst.data_ptr(), found.data_ptr(), slab.data_ptr(),
                lane.data_ptr(), *sizes,
                torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise SystemExit(f"slab_probe launch failed: code {rc}")
        return found, slab, lane
    return run


def contrib_entry(lib):
    """``(keys, owner, contrib, n) -> (S,) sums`` through a library's C
    entry point."""
    import torch
    fn = lib.slab_contrib_sums
    fn.argtypes = [_P] * 4 + [_I, ctypes.c_uint, _P]
    fn.restype = _I

    def run(keys, owner, contrib, n):
        out = torch.empty(keys.shape[0], dtype=torch.float32,
                          device=keys.device)
        rc = fn(keys.data_ptr(), owner.data_ptr(), contrib.data_ptr(),
                out.data_ptr(), keys.shape[0], n,
                torch.cuda.current_stream(keys.device).cuda_stream)
        if rc:
            raise SystemExit(f"slab_contrib_sums launch failed: code {rc}")
        return out
    return run


def contrib_variants(torch, cs, libs, tr):
    """Kernel 4's variants on the transpose ``tr``, in turns, beside kernel
    3's ``sum`` and the CSR product."""
    from repro_torch.kernels.slab_pagerank import (slab_contrib_sums,
                                                   slab_contrib_sums_ref)
    from repro_torch.kernels.slab_sweep import slab_sweep

    V = tr.n_vertices
    keys, owner = tr.keys, tr.slab_vertex
    gen = torch.Generator(device="cuda").manual_seed(1)
    contrib = torch.rand(V, generator=gen, device="cuda")
    want = slab_contrib_sums_ref(keys, owner, contrib, n_vertices=V)
    runs = {}
    for key in [k for k in libs if k[0] == "contrib"]:
        fn = contrib_entry(libs[key])
        got = fn(keys, owner, contrib, V)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if err > cs.SUM_RTOL * float(want.abs().max()) + 1e-30:
            raise SystemExit(f"{key}: differs from the plain version by "
                             f"{err}")
        runs[key[1]] = (lambda fn=fn: fn(keys, owner, contrib, V))
    runs["sweep_sum"] = lambda: slab_sweep(keys, owner, contrib,
                                           semiring="sum", n_vertices=V)
    a = cs.csr_of_pool(torch, keys, owner, V)
    runs["csr_mv"] = lambda: torch.mv(a, contrib)
    # the op's owner mask: a row's 128 flags reduced as bools and as 16
    # int64 words (the op's form)
    valid = (owner[:, None] >= 0) & (keys >= 0) & (keys < V)
    runs["mask_bool"] = lambda: valid.any(dim=1)
    runs["mask_int64"] = lambda: valid.view(torch.int64).any(dim=1)
    ms = in_turns(torch, cs, runs, None)
    op_ms = [cs.time_ms(torch, lambda: slab_contrib_sums(keys, valid,
                                                         contrib))
             for _ in range(2)]
    rows_alloc = int((owner >= 0).sum())
    print(json.dumps({
        "kernel": "slab_contrib_sums", "case": "transpose",
        "rows": keys.shape[0], "rows_allocated": rows_alloc, "ms": ms,
        "op_ms": op_ms,
        **cs.bound(rows_alloc * 512 + keys.shape[0] * 8 + V * 4,
                   rows_alloc * 128, ops_per_s=cs.INT32_OPS_PER_S)}),
        flush=True)
    del a


def chain_entry(lib, parent: bool):
    """``(next_slab, live_count, n_buckets) -> (base_rank, bucket_of,
    chain_pos, counts)``; the parent's entry point takes no queue."""
    import torch
    fn = lib.slab_chain_rank
    fn.argtypes = [_P] * (6 if parent else 7) + [_I, _I, _P]
    fn.restype = _I

    def run(nxt, cnt, nb):
        S, dev = nxt.shape[0], nxt.device
        outs = [torch.empty(S, dtype=torch.int32, device=dev)
                for _ in range(3)]
        outs.append(torch.empty(nb, dtype=torch.int32, device=dev))
        queue = [] if parent else [torch.empty(
            4 * nb + 1, dtype=torch.int32, device=dev).data_ptr()]
        rc = fn(nxt.data_ptr(), cnt.data_ptr(),
                *[t.data_ptr() for t in outs], *queue, S, nb,
                torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise SystemExit(f"slab_chain_rank launch failed: code {rc}")
        return tuple(outs)
    return run


def commit_entry(lib):
    """``(keys, degree, weights, *plan)``, in place, through a library's C
    entry point (an earlier checkout's takes the same arguments)."""
    import torch
    fn = lib.slab_commit
    fn.argtypes = [_P] * 9 + [_I, _I, _I, _P]
    fn.restype = _I

    def run(keys, deg, w, e_slab, e_lane, vals, idx, delta, wv=None):
        ptr = [None if a is None else a.data_ptr() for a in (w, wv)]
        rc = fn(keys.data_ptr(), deg.data_ptr(), ptr[0], e_slab.data_ptr(),
                e_lane.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                delta.data_ptr(), ptr[1], keys.shape[0], deg.shape[0],
                e_slab.shape[0],
                torch.cuda.current_stream(keys.device).cuda_stream)
        if rc:
            raise SystemExit(f"slab_commit launch failed: code {rc}")
    return run


def bag_entry(lib):
    """``(indices, weights, table) -> (B, D)`` through a library's C entry
    point (an earlier checkout's takes the same arguments)."""
    import torch
    fn = lib.embedding_bag
    fn.argtypes = [_P] * 4 + [_I] * 5 + [_P]
    fn.restype = _I

    def run(idx, w, tab):
        (B, L), (N, D) = idx.shape, tab.shape
        out = torch.empty((B, D), dtype=tab.dtype, device=tab.device)
        rc = fn(idx.data_ptr(), w.data_ptr(), tab.data_ptr(), out.data_ptr(),
                B, L, N, D, 0 if tab.dtype == torch.float32 else 1,
                torch.cuda.current_stream(tab.device).cuda_stream)
        if rc:
            raise SystemExit(f"embedding_bag launch failed: code {rc}")
        return out
    return run


def in_turns(torch, cs, runs, flush):
    """Device ms of each ``name -> fn`` in ``runs``, timed forward then
    backward."""
    ms = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            ms[name].append(cs.device_ms(torch, runs[name], flush=flush))
    return ms


def probe_and_chain(torch, cs, libs, kernels, got):
    """The probe and chain-walk variants on the serve's captured inputs and
    on their relabelled copies."""
    from repro_torch.kernels.slab_compact import chain_rank_torch
    from repro_torch.kernels.slab_update import slab_probe_torch

    flush = torch.empty(1 << 26, dtype=torch.int32, device="cuda")
    nb = got["n_buckets"]

    def held(name, fn, want, what):
        k = fn()
        torch.cuda.synchronize()
        if not all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(k, want)):
            raise SystemExit(f"{name} differs from the plain version on "
                             f"{what}")

    if "probe" in kernels:
        entries = {k[1]: probe_entry(lib, k[1] == "parent")
                   for k, lib in libs.items() if k[0] == "probe"}
        for B, (keys, nxt, start, dst) in sorted(got["probe"].items()):
            pnxt, pkeys = cs.relabelled(torch, nxt, nb, keys)
            row = {"kernel": "slab_probe", "case": f"B={B}",
                   **cs.probe_walks(torch, keys, nxt, start, dst),
                   "contiguous_links": cs.contiguous_links(torch, nxt, nb)}
            for form, (kk, nn) in (("ms", (keys, nxt)),
                                   ("relabelled_ms", (pkeys, pnxt))):
                want = slab_probe_torch(kk, nn, start, dst)
                for name, fn in entries.items():
                    held(name, lambda: fn(kk, nn, start, dst), want,
                         f"B={B} ({form})")
                row[form] = in_turns(torch, cs, {
                    name: (lambda fn=fn: fn(kk, nn, start, dst))
                    for name, fn in entries.items()}, flush)
            # the committed kernel with the L2 left warm, and on queries
            # that are all inactive (launch, and B warps that read their
            # query and write their outputs)
            fn = entries["committed"]
            idle = torch.full_like(start, -1)
            row["committed_unflushed_ms"] = cs.device_ms(
                torch, lambda: fn(keys, nxt, start, dst))
            row["committed_inactive_ms"] = cs.device_ms(
                torch, lambda: fn(keys, nxt, idle, dst), flush=flush)
            print(json.dumps(row), flush=True)
            del pnxt, pkeys

    if "chain" in kernels:
        entries = {k[1]: chain_entry(lib, k[1] == "parent")
                   for k, lib in libs.items() if k[0] == "chain"}
        nxt, cnt, nbc = got["chain"]
        pnxt, pcnt = cs.relabelled(torch, nxt, nbc, cnt)
        want = chain_rank_torch(nxt, cnt, nbc)
        row = {"kernel": "slab_chain_rank", "case": "forward view",
               "longest_chain": int(want[2].max()) + 1,
               "chains_past_2_rows": int((want[2] == 2).sum()),
               "contiguous_links": cs.contiguous_links(torch, nxt, nbc)}
        for form, (nn, cc) in (("ms", (nxt, cnt)),
                               ("relabelled_ms", (pnxt, pcnt))):
            want = chain_rank_torch(nn, cc, nbc)
            for name, fn in entries.items():
                held(name, lambda: fn(nn, cc, nbc), want, form)
            row[form] = in_turns(torch, cs, {
                name: (lambda fn=fn: fn(nn, cc, nbc))
                for name, fn in entries.items()}, flush)
        row["committed_unflushed_ms"] = cs.device_ms(
            torch, lambda: entries["committed"](nxt, cnt, nbc))
        print(json.dumps(row), flush=True)


#: a commit plan past the threads the card holds at once (132 SMs x 2,048),
#: where the ``stride`` variants walk the plan more than once
WIDE_PLAN = 1 << 20


def wide_plan(torch, S, V, B, device, seed=0):
    """A synthetic insert plan of B entries on the serve's pool: distinct
    (slab, lane) targets drawn at random, ``deg_idx`` sorted over random
    vertices in runs of 1-8, +1 deltas, the key a vertex id."""
    gen = torch.Generator(device=device).manual_seed(seed)
    slots = torch.randperm(S * 128, generator=gen, device=device)[:B]
    e_slab = (slots // 128).to(torch.int32)
    e_lane = (slots % 128).to(torch.int32)
    lengths = torch.randint(1, 9, (B,), generator=gen, device=device)
    run_of = torch.repeat_interleave(torch.arange(B, device=device),
                                     lengths)[:B]
    verts = torch.randint(0, V, (B,), generator=gen, device=device)
    deg_idx = verts.sort().values[run_of].to(torch.int32)
    vals = torch.randint(0, V, (B,), generator=gen, device=device,
                         dtype=torch.int32)
    return (e_slab, e_lane, vals, deg_idx,
            torch.ones(B, dtype=torch.int32, device=device))


def commit_variants(torch, cs, libs, got):
    """The commit variants on the serve's captured plans (the delete and the
    insert batch of the forward view) and on a synthetic plan of
    ``WIDE_PLAN`` entries on the insert plan's pool: each equal to the
    plain version, then timed in turns on the plan and on the same plan
    with every entry parked (no store, no atomic)."""
    from repro_torch.kernels.slab_update import slab_commit_torch

    entries = {k[1]: commit_entry(lib) for k, lib in libs.items()
               if k[0] == "commit"}
    plans = sorted(got["commit"].items())
    keys, deg = plans[-1][1][:2]
    plans.append((WIDE_PLAN, (keys, deg, None, *wide_plan(
        torch, keys.shape[0], deg.shape[0], WIDE_PLAN, keys.device))))
    for B, (keys, deg, w, *plan) in plans:
        S, V = keys.shape[0], deg.shape[0]
        want = (keys.clone(), deg.clone())
        slab_commit_torch(*want, None if w is None else w.clone(), *plan)
        for name, fn in entries.items():
            kk, dd = keys.clone(), deg.clone()
            fn(kk, dd, None if w is None else w.clone(), *plan)
            torch.cuda.synchronize()
            if not (torch.equal(kk, want[0]) and torch.equal(dd, want[1])):
                raise SystemExit(f"slab_commit {name} differs from the plain "
                                 f"version at B={B}")
        parked = [torch.full_like(plan[0], S), plan[1], plan[2],
                  torch.full_like(plan[3], V), *plan[4:]]
        kk, dd = keys.clone(), deg.clone()
        row = {"kernel": "slab_commit", "case": f"B={B}",
               **cs.degree_runs(torch, plan[3], V)}
        for form, p in (("ms", plan), ("parked_ms", parked)):
            row[form] = in_turns(torch, cs, {
                name: (lambda fn=fn, p=p: fn(kk, dd, None, *p))
                for name, fn in entries.items()}, None)
        print(json.dumps(row), flush=True)


def bag_variants(torch, np, cs, libs):
    """The EmbeddingBag variants on phase 6's three calls: each within
    ``chip_smoke.BAG_TOL`` of the plain version, then timed in turns with
    the L2 warm and flushed; and a plain gather of the B=65,536 bags' rows
    (the card's L2 gather rate on them)."""
    from repro_torch.kernels.embedding_bag import embedding_bag_ref

    tables, bags, calls = cs.bag_inputs(torch, np)
    entries = {k[1]: bag_entry(lib) for k, lib in libs.items()
               if k[0] == "bag"}
    flush = torch.empty(1 << 26, dtype=torch.int32, device="cuda")
    for call, B, dt in calls:
        idx, w = bags[B]
        tab = tables[dt]
        want = embedding_bag_ref(idx, w, tab)
        tol = cs.BAG_TOL[dt]
        for name, fn in entries.items():
            got = fn(idx, w, tab).float()
            torch.cuda.synchronize()
            if not torch.allclose(got, want, atol=tol, rtol=tol):
                raise SystemExit(f"embedding_bag {name} differs from the "
                                 f"plain version ({call})")
        row = {"kernel": "embedding_bag", "case": call,
               "valid_slots": int((idx >= 0).sum())}
        for form, fl in (("ms", None), ("flushed_ms", flush)):
            row[form] = in_turns(torch, cs, {
                name: (lambda fn=fn: fn(idx, w, tab))
                for name, fn in entries.items()}, fl)
        print(json.dumps(row), flush=True)

    fn = libs[("gather", "rows")].row_gather
    fn.argtypes = [_P, _I, _P, _I, _P, _I, _P]
    fn.restype = _I
    blocks = 132 * 8
    out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
    idx, _ = bags[cs.BAG_BATCHES[-1]]
    flat = idx[idx >= 0].contiguous()
    for dt, tab in tables.items():
        row_bytes = tab.shape[1] * tab.element_size()

        def gather():
            rc = fn(flat.data_ptr(), flat.numel(), tab.data_ptr(), row_bytes,
                    out.data_ptr(), blocks,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"row_gather launch failed: code {rc}")
        n_bytes = flat.numel() * row_bytes
        ms = cs.device_ms(torch, gather)
        flushed = cs.device_ms(torch, gather, flush=flush)
        print(json.dumps({
            "kernel": "row_gather", "case": f"B={cs.BAG_BATCHES[-1]} {dt}",
            "rows": int(flat.numel()),
            "distinct_rows": int(torch.unique(flat).numel()),
            "bytes": n_bytes, "ms": ms, "flushed_ms": flushed,
            "gather_GBps": n_bytes / ms / 1e6,
            "flushed_gather_GBps": n_bytes / flushed / 1e6}), flush=True)


def hits_variants(torch, np, cs, libs, sym, src, dst):
    """The membership probe's variants on the triangle phase's kind of
    call: 5,120 (u, w) queries on the hashed symmetric view, half of them
    edges of the graph, with each query's bucket chain as its candidate
    rows (``materialize_chains`` to the pool's longest chain); on the
    same queries with 8 random rows of the pool each (C = 8, almost all
    misses); and on the first 256 of them with 8 random rows (too few
    warps to hide one another's round trips).  Each is held to the plain
    version exactly (but a variant that is not the function), then timed
    with the L2 flushed before each call and warm, through the C entry
    point."""
    from repro_torch.core.slab_graph import pool_stats
    from repro_torch.kernels.slab_intersect import probe_hits_torch
    from repro_torch.kernels.slab_intersect.ops import materialize_chains

    rng = np.random.default_rng(4)
    n, V = 2560, int(sym.bucket_count.shape[0])
    pick = rng.choice(len(src), n, replace=False)
    qs = np.concatenate([src[pick], rng.integers(0, V, n)]).astype(np.uint32)
    qd = np.concatenate([dst[pick], rng.integers(0, V, n)]).astype(np.uint32)
    us, ws_all = (torch.from_numpy(a.view(np.int32).copy()).cuda()
                  for a in (qs, qd))
    mask = torch.ones(2 * n, dtype=torch.bool, device="cuda")
    S = sym.keys.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {
        "bucket chains": materialize_chains(
            sym, us, ws_all, mask, max_chain=pool_stats(sym)["max_chain"]),
        "8 random rows": torch.randint(0, S, (2 * n, 8), generator=gen,
                                       device="cuda", dtype=torch.int32),
        "few queries": torch.randint(0, S, (256, 8), generator=gen,
                                     device="cuda", dtype=torch.int32)}
    flush = torch.empty(1 << 26, dtype=torch.int32, device="cuda")
    for case, rows in cases.items():
        Q, C = rows.shape
        ws = ws_all[:Q]
        want = probe_hits_torch(ws, rows, sym.keys)
        entries = {}
        for key, lib in libs.items():
            if key[0] != "hits":
                continue
            fn = lib.probe_hits
            fn.argtypes = [_P] * 4 + [_I] * 3 + [_P]
            fn.restype = _I

            def call(fn=fn, rows=rows, Q=Q, C=C):
                out = torch.empty(Q, dtype=torch.bool, device="cuda")
                rc = fn(ws.data_ptr(), rows.data_ptr(), sym.keys.data_ptr(),
                        out.data_ptr(), Q, C, S,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise SystemExit(f"probe_hits launch failed: code {rc}")
                return out
            got = call()
            torch.cuda.synchronize()
            exact = not VARIANTS.get(key, ("",))[0].startswith("(not")
            if exact and not torch.equal(got, want):
                raise SystemExit(f"{key} differs from the plain version")
            entries[key[1]] = call
        print(json.dumps({"kernel": "probe_hits",
                          "case": f"{case}: Q={Q}, C={C}",
                          "hits": int(want.sum()),
                          "valid_rows": int((rows >= 0).sum()),
                          "flushed_ms": in_turns(torch, cs, entries, flush),
                          "ms": in_turns(torch, cs, entries, None)}),
              flush=True)


def dense_items(g2, us, vs, emask, *, max_bpv):
    """The dense (edge, bucket) layout the parent's ops built: per slot the
    head slab of v's bucket (-1 = inactive) and u."""
    import torch
    v = torch.where(emask, vs, 0).long()
    j = torch.arange(max_bpv, dtype=torch.int32, device=us.device)[None, :]
    bmask = emask[:, None] & (j < g2.bucket_count[v][:, None])
    start = torch.where(bmask, g2.bucket_offset[v][:, None] + j,
                        -1).reshape(-1).to(torch.int32)
    u = torch.where(bmask, us[:, None], 0).reshape(-1).to(torch.int32)
    return start, u


def sweep_and_count(torch, np, cs, libs, args, kernels):
    """The sweep and count variants on the serve's RMAT graph."""
    from repro_torch.algorithms import triangle as tri
    from repro_torch.core.slab_graph import from_edges_host
    from repro_torch.data import synth
    from repro_torch.kernels import runtime
    from repro_torch.kernels.slab_intersect import kernel as ik
    from repro_torch.kernels.slab_intersect import ops as iops
    from repro_torch.kernels.slab_intersect import slab_count_torch
    from repro_torch.kernels.slab_sweep import slab_sweep, slab_sweep_ref
    from repro_torch.stream import dedup_pairs

    t0 = time.perf_counter()
    V = 1 << 20
    src, dst = synth.rmat_edges(V, 1 << 24, seed=0)
    src, dst, _ = dedup_pairs(src, dst)
    fwd = (from_edges_host(V, src, dst, hashing=False, device="cuda")
           if "sweep" in kernels else None)
    if "contrib" in kernels:
        tr = from_edges_host(V, dst, src, hashing=False, device="cuda")
        print(json.dumps({"graphs_s": time.perf_counter() - t0,
                          "edges": int(len(src))}), flush=True)
        contrib_variants(torch, cs, libs, tr)
        del tr
        if not kernels & {"sweep", "count", "hits"}:
            return
    sym = from_edges_host(V, np.concatenate([src, dst]),
                          np.concatenate([dst, src]), hashing=True,
                          device="cuda")
    print(json.dumps({"graphs_s": time.perf_counter() - t0,
                      "edges": int(len(src))}), flush=True)

    if "sweep" in kernels:
        # -- sweep ------------------------------------------------------------
        gen = torch.Generator(device="cuda").manual_seed(0)
        values = torch.rand(V, generator=gen, device="cuda")
        frontier = torch.rand(V, generator=gen, device="cuda") < 0.3
        cases = {"sum": dict(semiring="sum", frontier=None),
                 "min_plus+frontier": dict(semiring="min_plus",
                                           frontier=frontier)}
        keys, owner = fwd.keys, fwd.slab_vertex
        sweep_names = [k for k in libs if k[0] == "sweep"]
        for case, kw in cases.items():
            want = slab_sweep_ref(keys, owner, values, n_vertices=V, **kw)
            for key in sweep_names:
                runtime._libs["slab_sweep"] = libs[key]
                got = slab_sweep(keys, owner, values, n_vertices=V, **kw)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                ok = (err <= cs.SUM_RTOL * float(want.abs().max()) + 1e-30
                      if kw["semiring"] == "sum" else torch.equal(got, want))
                if not ok:
                    raise SystemExit(f"{key} {case}: differs from the plain "
                                     f"version by {err}")
            ms = {key: [] for key in sweep_names}
            for order in (sweep_names, sweep_names[::-1]):
                for key in order:
                    runtime._libs["slab_sweep"] = libs[key]
                    ms[key].append(cs.device_ms(torch, lambda: slab_sweep(
                        keys, owner, values, n_vertices=V, **kw)))
            row = {"kernel": "slab_sweep", "case": case,
                   "ms": {k[1]: v for k, v in ms.items()}}
            if case == "sum":
                a = cs.csr_of_pool(torch, keys, owner, V)
                row["csr_mv_ms"] = [cs.device_ms(torch, lambda: torch.mv(
                    a, values)) for _ in range(2)]
                del a
            print(json.dumps(row), flush=True)

    if "hits" in kernels:
        hits_variants(torch, np, cs, libs, sym, src, dst)
    if "count" not in kernels:
        return
    # -- count ----------------------------------------------------------------
    mb = tri._sym_bpv(sym)
    es, ed, n, _ = tri.compact_edges(sym, max_edges=tri.next_pow2(
        int(sym.n_edges)))
    n = int(n)
    chunk = 8192
    per_edge = sym.bucket_count[ed[:n].long()].clamp(max=mb).long()
    per_chunk = torch.zeros((n + chunk - 1) // chunk, dtype=torch.int64,
                            device="cuda").index_add_(
        0, torch.arange(n, device="cuda") // chunk, per_edge)
    c0 = int(per_chunk.argmax()) * chunk
    us, vs = es[c0:c0 + chunk], ed[c0:c0 + chunk]
    m = torch.arange(chunk, device="cuda") < (n - c0)
    us = torch.nn.functional.pad(us, (0, chunk - us.numel()))
    vs = torch.nn.functional.pad(vs, (0, chunk - vs.numel()))
    items = {"active": iops._work_items(sym, us, vs, m, max_bpv=mb),
             "dense": dense_items(sym, us, vs, m, max_bpv=mb)}
    pool = (sym.keys, sym.next_slab, sym.bucket_offset, sym.bucket_count,
            sym.keys, sym.next_slab)
    want = slab_count_torch(*pool, *items["active"])
    flush = torch.empty(1 << 26, dtype=torch.int32, device="cuda")
    runs = [(k, "active") for k in libs if k[0] == "count"]
    if args.parent is not None:
        runs.append((("count", "parent"), "dense"))
    for key, layout in runs:
        runtime._libs["slab_intersect"] = libs[key]
        got = ik.slab_count(*pool, *items[layout])
        torch.cuda.synchronize()
        if layout == "dense":
            got = got[items["dense"][0] != -1]
        if not torch.equal(got, want):
            raise SystemExit(f"{key} on the {layout} items differs from "
                             f"the plain version")
    ms = {f"{k[1]}/{lay}": [] for k, lay in runs}
    for order in (runs, runs[::-1]):
        for key, layout in order:
            runtime._libs["slab_intersect"] = libs[key]
            ms[f"{key[1]}/{layout}"].append(cs.device_ms(
                torch, lambda: ik.slab_count(*pool, *items[layout]),
                flush=flush))
    print(json.dumps({"kernel": "slab_count", "case": "static chunk",
                      "items": {k: int(v[0].numel())
                                for k, v in items.items()},
                      "total": int(want.sum()), "ms": ms}), flush=True)

    # -- every chunk of the static count -------------------------------------
    deg = sym.degree.long()
    bc = sym.bucket_count.long()
    chunks, info = [], []
    for c0 in range(0, n, chunk):
        cu, cv = es[c0:min(c0 + chunk, n)], ed[c0:min(c0 + chunk, n)]
        cm = torch.ones(cu.numel(), dtype=torch.bool, device="cuda")
        cand = deg[cv.long()]
        multi = bc[cu.long()] > 1
        chunks.append((cu, cv, cm))
        info.append(torch.stack([cand.sum(), (cand * multi).sum(),
                                 bc[cu.long()].max()]))
    info = torch.stack(info).cpu().tolist()
    runtime._libs["slab_intersect"] = libs[("count", "committed")]
    for cu, cv, cm in chunks:                  # one pass to warm up
        ik.slab_count(*pool, *iops._work_items(sym, cu, cv, cm, max_bpv=mb))
    per_chunk = {}
    for key, layout in runs:
        runtime._libs["slab_intersect"] = libs[key]
        make = iops._work_items if layout == "active" else dense_items
        ev = []
        t = time.perf_counter()
        for cu, cv, cm in chunks:
            it = make(sym, cu, cv, cm, max_bpv=mb)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            ik.slab_count(*pool, *it)
            b.record()
            ev.append((a, b))
        torch.cuda.synchronize()
        host = time.perf_counter() - t
        per_chunk[f"{key[1]}/{layout}"] = (
            [a.elapsed_time(b) for a, b in ev], host)
    base = per_chunk["committed/active"][0]
    multi_heavy = [i for i, x in enumerate(info) if x[1] > x[0] / 2]
    top = sorted(range(len(base)), key=lambda i: -base[i])[:8]
    print(json.dumps({
        "kernel": "slab_count", "case": "every static chunk",
        "chunks": len(base), "candidates": sum(x[0] for x in info),
        "candidates_multi_bucket_u": sum(x[1] for x in info),
        "chunks_mostly_multi_bucket_u": len(multi_heavy),
        "kernel_ms_sum": {k: sum(v[0]) for k, v in per_chunk.items()},
        "kernel_ms_multi_heavy": {k: sum(v[0][i] for i in multi_heavy)
                                  for k, v in per_chunk.items()},
        "loop_s": {k: v[1] for k, v in per_chunk.items()},
        "top": [{"chunk": i, "candidates": info[i][0],
                 "multi_bucket_candidates": info[i][1],
                 "max_u_buckets": info[i][2],
                 "ms": {k: v[0][i] for k, v in per_chunk.items()}}
                for i in top]}), flush=True)

    # -- the static count end to end -----------------------------------------
    real_items = iops._work_items
    static = {}
    whole = [("count", "committed")] + (
        [("count", "parent")] if args.parent is not None else [])
    for key in whole + whole[::-1]:
        runtime._libs["slab_intersect"] = libs[key]
        iops._work_items = (
            (lambda *a, **k: dense_items(*a, **k)) if key[1] == "parent"
            else real_items)
        t = time.perf_counter()
        total = int(tri.triangles_static(sym, max_bpv=mb))
        torch.cuda.synchronize()
        static.setdefault(key[1], []).append(time.perf_counter() - t)
        static.setdefault("triangles", set()).add(total)
    iops._work_items = real_items
    check = static.pop("triangles")
    if len(check) != 1:
        raise SystemExit(f"the static counts differ: {sorted(check)}")
    print(json.dumps({"static_count_s": static,
                      "triangles": check.pop()}), flush=True)


def serve_turns(cs, parent):
    """The serve end to end from this checkout and the parent's, in turns;
    each run builds its kernels before it boots."""
    roots = {"committed": ROOT, "parent": Path(parent).resolve()}
    code = ("import sys\n"
            "from repro_torch.kernels import runtime\n"
            "runtime.build()\n"
            "from repro_torch.launch import serve\n"
            "serve.main(sys.argv[1:])\n")
    for name in ("parent", "committed", "committed", "parent"):
        env = dict(os.environ, PYTHONPATH=str(roots[name] / "src"))
        out = subprocess.run([sys.executable, "-c", code, *cs.SERVE_ARGS],
                             cwd=roots[name], env=env, capture_output=True,
                             text=True, check=True).stdout
        reqs = re.findall(r"\[serve\] req \d+ (\S+)\s+([\d.]+) ms", out)
        last = re.findall(r"\[serve\] maintenance: .*", out)
        print(json.dumps({"serve": name,
                          "ms": [[kind, float(ms)] for kind, ms in reqs],
                          "maintenance": last[-1] if last else None}),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--kernels", default=",".join(SOURCES))
    args = ap.parse_args()
    kernels = set(args.kernels.split(","))
    if not kernels <= set(SOURCES) | {"serve"}:
        raise SystemExit(f"--kernels: pick from {sorted(SOURCES)} and serve")
    if "serve" in kernels and args.parent is None:
        raise SystemExit("--kernels serve needs --parent")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("slab_variants: no CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs

    print(cs.gpu_line(), flush=True)
    captured = kernels & {"probe", "chain", "commit"}
    if captured:
        from repro_torch.kernels import runtime
        runtime.build()              # the committed kernels the serve runs
    libs = build(args.parent, kernels)
    if captured:
        from repro_torch.launch import serve as serve_mod
        t0 = time.perf_counter()
        got, _ = cs.capture_serve_inputs(torch, np, serve_mod)
        print(json.dumps({"capture_s": time.perf_counter() - t0}),
              flush=True)
        if "commit" in kernels:
            commit_variants(torch, cs, libs, got)
        probe_and_chain(torch, cs, libs, kernels, got)
        del got
        torch.cuda.empty_cache()
    if "bag" in kernels:
        bag_variants(torch, np, cs, libs)
        torch.cuda.empty_cache()
    if kernels & {"sweep", "count", "hits", "contrib"}:
        sweep_and_count(torch, np, cs, libs, args, kernels)
    if "serve" in kernels:
        serve_turns(cs, args.parent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
