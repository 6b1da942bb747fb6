#!/usr/bin/env python3
"""Build variants of the slab-sweep and intersection-count sources and hold
each beside the committed kernel on one CUDA card.

    python3 tools/slab_variants.py [--parent DIR]

Each variant is the committed ``src/repro_torch/csrc/slab_sweep.cu`` or
``slab_intersect.cu`` with a few lines edited (``VARIANTS``); ``--parent``
adds the sources of another checkout (an unpacked earlier commit) under the
name ``parent``.  All are compiled in parallel into
``build/slab_variants/`` and loaded with ctypes: their C entry points are
the committed ones'.  The inputs are the serve's graph (RMAT scale 20,
2**24 generated edges, seed 0, deduplicated): its forward view unhashed,
as the serve sweeps it, and its symmetric view hashed, as the triangle
phase counts on it.  For each variant the script prints:

* the sweep's device time for ``sum`` (no frontier; PageRank's sweep) and
  ``min_plus`` with a random 30% frontier (BFS's), and the CSR
  ``torch.mv`` of the same sums beside them;
* the count's device time on the static count's busiest chunk (8,192
  edges, the most (edge, bucket) items), on the active items, with the L2
  flushed before each call; the parent also on the dense (edge, bucket)
  layout its ops built;
* the static count (``triangles_static``) end to end, host clock, with the
  variant's library in the engine (the parent with its dense layout).

Every variant is checked against the plain version first (the sum within
``chip_smoke.SUM_RTOL``, all else exactly).  Variants are timed in turns,
forward then backward.  Exits nonzero without a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "slab_variants"

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
}


def build(parent):
    from repro_torch.kernels import runtime

    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for (src, name), (_, edits) in VARIANTS.items():
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
        for src in ("slab_sweep", "slab_intersect"):
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
        print(json.dumps({"build": f"{key[0]}/{key[1]}", "ptxas": regs[:6]}),
              flush=True)
        libs[key] = ctypes.CDLL(str(so))
    return libs


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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("slab_variants: no CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.algorithms import triangle as tri
    from repro_torch.core.slab_graph import from_edges_host
    from repro_torch.data import synth
    from repro_torch.kernels import runtime
    from repro_torch.kernels.slab_intersect import kernel as ik
    from repro_torch.kernels.slab_intersect import ops as iops
    from repro_torch.kernels.slab_intersect import slab_count_torch
    from repro_torch.kernels.slab_sweep import slab_sweep, slab_sweep_ref
    from repro_torch.stream import dedup_pairs

    print(cs.gpu_line(), flush=True)
    libs = build(args.parent)
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

    # -- sweep ----------------------------------------------------------------
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

    # -- every chunk of the static count ---------------------------------------
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

    # -- the static count end to end -------------------------------------------
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
