#!/usr/bin/env python3
"""Build variants of the slab kernels' sources and hold each beside the
committed kernel on one CUDA card.

    python3 tools/slab_variants.py [--parent DIR] [--kernels LIST]

Each variant is a committed source of ``src/repro_torch/csrc/`` with a few
lines edited (``VARIANTS``); ``--parent`` adds the sources of another
checkout (an unpacked earlier commit) under the name ``parent``.  All are
compiled in parallel into ``build/slab_variants/`` and loaded with ctypes.
``--kernels`` picks among ``sweep``, ``count`` (``slab_sweep.cu``,
``slab_intersect.cu``), ``probe`` and ``chain`` (``slab_update.cu``,
``slab_compact.cu``); the default is all four.  ``serve`` (with
``--parent``) also runs the serve of ``chip_smoke.SERVE_ARGS`` end to end
from this checkout and from the parent's, each in its own process, in turns
(parent, committed, committed, parent), and prints each request's latency.

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

Probe and chain walk run on the inputs the serve hands them
(``chip_smoke.capture_serve_inputs``: the first probe of each batch size and
the first compaction's chain walk, forward view), and on a copy of each
pool whose overflow rows are relabelled by a seeded permutation
(``chip_smoke.relabelled``), where almost no link is ``r -> r + 1``: the
device time of each variant, L2 flushed before each call.  These variants
are called through their C entry points directly, since the parent's take
other arguments than the committed wrappers pass.

Every variant is checked against the plain version first (the sum within
``chip_smoke.SUM_RTOL``, all else exactly).  Variants are timed in turns,
forward then backward.  Exits nonzero without a CUDA card.
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

#: (source, name) -> (what it changes, [(committed text, replacement)])
VARIANTS = {
    ("slab_sweep", "committed"): ("the source as committed", []),
    ("slab_sweep", "eager"): (
        "the first step's keys read beside the owner, not after it",
        [("  bool open = row < S && owner[row] >= 0;\n",
          "  const uint4 kv0 = row < S ? reinterpret_cast<const uint4*>(\n"
          "      keys + static_cast<size_t>(row) * kSlabWidth)[j]\n"
          "      : make_uint4(0, 0, 0, 0);\n"
          "  bool open = row < S && owner[row] >= 0;\n"),
         ("      const uint4 kv = k4[s * kGroup];\n",
          "      const uint4 kv = s == 0 ? kv0 : k4[s * kGroup];\n")]),
    ("slab_sweep", "group1"): (
        "a thread a row: 16 B steps, 32 rows a warp",
        [("constexpr int kGroup = 4;", "constexpr int kGroup = 1;")]),
    ("slab_sweep", "group2"): (
        "2 threads a row: 32 B steps (one sector), 16 rows a warp",
        [("constexpr int kGroup = 4;", "constexpr int kGroup = 2;")]),
    ("slab_sweep", "group8"): (
        "8 threads a row: 128 B steps, four rows a warp",
        [("constexpr int kGroup = 4;", "constexpr int kGroup = 8;")]),
    ("slab_sweep", "group16"): (
        "16 threads a row: 256 B steps, two rows a warp",
        [("constexpr int kGroup = 4;", "constexpr int kGroup = 16;")]),
    ("slab_sweep", "group32"): (
        "a warp a row, reading its 512 B up to the first EMPTY lane",
        [("constexpr int kGroup = 4;", "constexpr int kGroup = 32;")]),
    ("slab_intersect", "committed"): ("the source as committed", []),
    ("slab_intersect", "quads1"): (
        "a probe thread loads one uint4 (16 B) a step",
        [("constexpr int kProbeQuads = 4;", "constexpr int kProbeQuads = 1;")]),
    ("slab_intersect", "quads2"): (
        "a probe thread loads two uint4 (32 B, one sector) a step",
        [("constexpr int kProbeQuads = 4;", "constexpr int kProbeQuads = 2;")]),
    ("slab_intersect", "quads8"): (
        "a probe thread loads eight uint4 (128 B) a step",
        [("constexpr int kProbeQuads = 4;", "constexpr int kProbeQuads = 8;")]),
    ("slab_intersect", "group4"): (
        "4-thread probes (64 B steps, eight probes a warp)",
        [("constexpr int kProbeGroup = 1;", "constexpr int kProbeGroup = 4;")]),
    ("slab_intersect", "group8"): (
        "8-thread probes (128 B steps, four probes a warp)",
        [("constexpr int kProbeGroup = 1;", "constexpr int kProbeGroup = 8;")]),
    ("slab_update", "committed"): ("the source as committed", []),
    ("slab_update", "pointer"): (
        "the chain pointer issued with the row, no run followed",
        [("    const int nw = w < S ? next_slab[w] : -1;\n",
          "    const int nw = t == 0 ? next_slab[cur] : -1;\n"),
         ("    const unsigned linked =\n"
          "        __ballot_sync(0xffffffffu, nw == w + 1 && w + 1 < S);\n",
          "    const unsigned linked = 0u;\n")]),
    ("slab_update", "rows1"): (
        "a run followed one row a step",
        [("constexpr int kRunRows = 8;", "constexpr int kRunRows = 1;")]),
    ("slab_update", "rows4"): (
        "a run followed four rows a step",
        [("constexpr int kRunRows = 8;", "constexpr int kRunRows = 4;")]),
    ("slab_update", "rows8occ"): (
        "eight rows a step, registers held to six blocks an SM",
        [("__global__ void probe_kernel(",
          "__global__ void __launch_bounds__(256, 6) probe_kernel(")]),
    ("slab_update", "rows16"): (
        "a run followed sixteen rows a step",
        [("constexpr int kRunRows = 8;", "constexpr int kRunRows = 16;")]),
    ("slab_update", "coop"): (
        "a walk past 64 rows handed to a block of 8 warps (second launch), "
        "its warps taking alternate rows of each run",
        [("constexpr int kRunRows = 8;\n", "constexpr int kRunRows = 8;\n"
          + _COOP_DECLS),
         ("    left -= run + 1;\n"
          "    cur = __shfl_sync(0xffffffffu, nw, run);\n  }\n",
          "    left -= run + 1;\n"
          "    cur = __shfl_sync(0xffffffffu, nw, run);\n" + _COOP_HANDOFF
          + "  }\n"),
         ("__global__ void commit_kernel(",
          _COOP_KERNEL + "__global__ void commit_kernel("),
         ("    probe_kernel<<<blocks,", _COOP_RESET + "    probe_kernel<<<blocks,"),
         ("        static_cast<int32_t*>(lane), S, B);\n",
          "        static_cast<int32_t*>(lane), S, B);\n" + _COOP_LAUNCH)]),
    ("slab_compact", "committed"): ("the source as committed", []),
    ("slab_compact", "hops1"): (
        "a thread walks one row (its head) before its chain is queued",
        [("constexpr int kThreadHops = 2;", "constexpr int kThreadHops = 1;")]),
    ("slab_compact", "hops4"): (
        "a thread walks four rows before its chain is queued",
        [("constexpr int kThreadHops = 2;", "constexpr int kThreadHops = 4;")]),
    ("slab_compact", "ownwarp"): (
        "no queue: each warp walks its own threads' long chains in turn",
        [("  const unsigned want = __ballot_sync(0xffffffffu, going);\n",
          _OWN_WARP),
         ("    long_chain_kernel<<<", "    if (false) long_chain_kernel<<<")]),
}

#: kernel -> source, and the source's entry point
SOURCES = {"sweep": "slab_sweep", "count": "slab_intersect",
           "probe": "slab_update", "chain": "slab_compact"}


def build(parent, kernels):
    from repro_torch.kernels import runtime

    sources = {SOURCES[k] for k in kernels if k in SOURCES}
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for (src, name), (_, edits) in VARIANTS.items():
        if src not in sources:
            continue
        text = (CSRC / f"{src}.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{src}/{name}: edit no longer applies: "
                                 f"{old!r}")
            text = text.replace(old, new)
        path = OUT / f"{src}-{name}.cu"
        path.write_text(text)
        jobs[(src, name)] = path
    if parent is not None:
        for src in sorted(sources):
            jobs[(src, "parent")] = Path(parent) / "src" / "repro_torch" \
                / "csrc" / f"{src}.cu"
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
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(json.dumps({"build": f"{key[0]}/{key[1]}", "ptxas": regs[:8]}),
              flush=True)
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


def in_turns(torch, cs, runs, flush):
    """Device ms of each ``name -> fn`` in ``runs``, timed forward then
    backward."""
    ms = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            ms[name].append(cs.device_ms(torch, runs[name], flush=flush))
    return ms


def probe_and_chain(torch, np, cs, libs, kernels):
    """The probe and chain-walk variants on the serve's captured inputs and
    on their relabelled copies."""
    from repro_torch.kernels.slab_compact import chain_rank_torch
    from repro_torch.kernels.slab_update import slab_probe_torch
    from repro_torch.launch import serve as serve_mod

    t0 = time.perf_counter()
    got, _ = cs.capture_serve_inputs(torch, np, serve_mod)
    print(json.dumps({"capture_s": time.perf_counter() - t0}), flush=True)
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
                   for k, lib in libs.items() if k[0] == "slab_update"}
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
                   for k, lib in libs.items() if k[0] == "slab_compact"}
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
    fwd = from_edges_host(V, src, dst, hashing=False, device="cuda")
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
        sweep_names = [k for k in libs if k[0] == "slab_sweep"]
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
    runs = [(k, "active") for k in libs if k[0] == "slab_intersect"]
    if args.parent is not None:
        runs.append((("slab_intersect", "parent"), "dense"))
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
    runtime._libs["slab_intersect"] = libs[("slab_intersect", "committed")]
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
    whole = [("slab_intersect", "committed")] + (
        [("slab_intersect", "parent")] if args.parent is not None else [])
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
    if kernels & {"probe", "chain"}:
        from repro_torch.kernels import runtime
        runtime.build()              # the committed kernels the serve runs
    libs = build(args.parent, kernels)
    if kernels & {"probe", "chain"}:
        probe_and_chain(torch, np, cs, libs, kernels)
        torch.cuda.empty_cache()
    if kernels & {"sweep", "count"}:
        sweep_and_count(torch, np, cs, libs, args, kernels)
    if "serve" in kernels:
        serve_turns(cs, args.parent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
