#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Three phases, each printing JSON lines:

1. **build** - compile the CUDA sources under ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, in parallel) and print the card's name and power
   limit.
2. **kernels** - run the serving loop for one update and its two property
   reads at the serve configuration, capturing the arguments the main path
   hands each kernel; then hold every kernel against its plain PyTorch
   version on those inputs (probe, commit, and the sweep in all four
   semirings with and without a frontier) and time both with CUDA events:
   each kernel on the device alone (the card spins while the host queues
   the call between two events; the probe with the L2 cache flushed), each
   plain version per call, host syncs and launch gaps included.
3. **serve** - the port's ``launch.serve`` on the card at RMAT scale 20
   (1,048,576 vertices, 2**24 generated edges, 65,536-edge update batches
   with 25% deletes, 12 requests), with the launch counts zeroed just before
   and read just after; then a self-check without the reference: a static
   rebuild from the request generator's edge ledger must hold the same edge
   set, the same BFS tree and PageRank within tolerance, and membership
   answers must match the ledger.

Any failed check exits nonzero.  The last lines are the card's name and
power limit, the per-kernel JSON line and ``{"ok": true, "device": ...}``.
Exits nonzero without printing a result when no CUDA card is available or
when the repository's sources are missing.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

SERVE_ARGS = ["--device", "cuda", "--vertices", "1048576",
              "--initial-edges", "16777216", "--batch", "65536",
              "--delete-frac", "0.25", "--requests", "12", "--seed", "0"]
#: H100 SXM published rates (NVIDIA H100 datasheet): HBM3 bytes/s and
#: float32 (non-tensor-core) operations/s, used for every kernel's bound
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: PageRank tolerance of the self-check, in L1: both the maintained and the
#: static vector stop at an L1 step <= 1e-5 with damping 0.85, which leaves
#: each within 1e-5 * 0.85 / 0.15 = 5.7e-5 (L1) of the fixed point
PR_L1_TOL = 2.5e-4
#: float sum sweeps add the 128 lanes in another order than the plain
#: version: rounding of the row total, a few float32 ulp
SUM_RTOL = 1e-6


class SmokeFailure(Exception):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def time_ms(torch, fn, *, warmup: int = 1, reps: int = 5) -> float:
    """Median time of one call of ``fn`` in ms, from a CUDA event pair
    around each call: for the plain versions, whose host syncs and launch
    gaps are part of their cost."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(torch, fn, *, flush=None, warmup: int = 3,
              samples: int = 20) -> float:
    """Device time of one call of ``fn`` in ms, for calls that never wait
    for the host: each call is queued between two CUDA events while the
    card spins, so the interval holds the call and no host launch overhead.
    ``flush``, a tensor larger than the L2 cache, is overwritten before each
    call, for a caller that finds the cache cold.  The median of
    ``samples`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = 1 << 20                       # clock cycles, ~0.5 ms on an H100
    times = []
    while len(times) < samples:
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        fn()
        b.record()
        queued_in_time = not a.query()   # the spin outlasted the queuing
        b.synchronize()
        if queued_in_time:
            times.append(a.elapsed_time(b))
        elif spin >= 1 << 30:
            raise SmokeFailure("the host could not queue a timed call "
                               "within the spin")
        else:
            spin <<= 2
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float) -> dict:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(n_bytes)}


# ----------------------------------------------------------------------------
# phase 2: capture the main path's kernel inputs, compare and time
# ----------------------------------------------------------------------------

def capture_serve_inputs(torch, np, serve_mod):
    """Serve one update and its two property reads with every kernel call
    recorded: the first probe and commit of each batch size (the forward
    view's), and the first sweep of each (semiring, frontier) pair."""
    from repro_torch.kernels.slab_sweep import ops as sweep_ops
    from repro_torch.kernels.slab_update import ops as update_ops
    from repro_torch.stream import RequestPipeline

    real_probe, real_commit = update_ops.slab_probe, update_ops.slab_commit
    real_sweep = sweep_ops.slab_sweep
    got = {"probe": {}, "commit": {}, "sweep": {}}

    def probe(keys, next_slab, start, dst):
        key = start.shape[0]
        if key not in got["probe"]:
            got["probe"][key] = (keys.clone(), next_slab.clone(),
                                 start.clone(), dst.clone())
        return real_probe(keys, next_slab, start, dst)

    def commit(keys, degree, weights, *plan):
        key = plan[0].shape[0]
        if key not in got["commit"]:
            got["commit"][key] = (
                keys.clone(), degree.clone(),
                None if weights is None else weights.clone(),
                *[None if t is None else t.clone() for t in plan])
        return real_commit(keys, degree, weights, *plan)

    def sweep(keys, slab_vertex, values, weights=None, frontier=None,
              target=None, *, semiring, n_vertices):
        key = (semiring, frontier is not None)
        if key not in got["sweep"]:
            got["sweep"][key] = dict(
                keys=keys, slab_vertex=slab_vertex, values=values.clone(),
                weights=weights, target=None if target is None
                else target.clone(), n_vertices=n_vertices,
                frontier=None if frontier is None else frontier.clone())
        return real_sweep(keys, slab_vertex, values, weights, frontier,
                          target, semiring=semiring, n_vertices=n_vertices)

    # boot exactly as the serve phase does, with no request served yet
    args = serve_mod.parse_args(SERVE_ARGS[:-4] + ["--requests", "0",
                                                   "--seed", "0"])
    out = serve_mod.serve(args, log=lambda s: None)
    store, registry, ledger = out["store"], out["registry"], out["ledger"]
    # the serve phase's first update and its two property reads
    pairs = serve_mod.EdgeLedger.pairs(ledger.keys)
    reqs = [req for _, req in serve_mod.build_requests(
        args.vertices, (pairs[:, 0], pairs[:, 1]),
        np.random.default_rng(args.seed), n_requests=3, batch=args.batch,
        delete_frac=args.delete_frac, prop_names=["pagerank", "bfs_0"])]
    update_ops.slab_probe, update_ops.slab_commit = probe, commit
    sweep_ops.slab_sweep = sweep
    try:
        RequestPipeline(store, registry).run(reqs)
        torch.cuda.synchronize()
    finally:
        update_ops.slab_probe, update_ops.slab_commit = real_probe, \
            real_commit
        sweep_ops.slab_sweep = real_sweep
    return got, store


def probe_rows(torch, keys, next_slab, start, dst) -> int:
    """Distinct slab rows the probe must read for these queries."""
    cur = start.clone()
    seen = []
    while True:
        walking = cur != -1
        if not bool(walking.any()):
            break
        c = cur[walking].long()
        seen.append(c)
        hit = (keys[c] == dst[walking][:, None]).any(dim=1)
        nxt = torch.where(hit, torch.full_like(c, -1),
                          next_slab[c].long())
        cur = torch.full_like(cur, -1)
        cur[walking] = nxt.to(cur.dtype)
    return int(torch.unique(torch.cat(seen)).numel()) if seen else 0


def csr_of_pool(torch, keys, owner, n):
    """The live lanes of a pool as an (S, n) float32 CSR matrix of ones."""
    valid = (keys >= 0) & (keys < n) & (owner[:, None] >= 0)
    rows, lanes = torch.nonzero(valid, as_tuple=True)
    crow = torch.zeros(keys.shape[0] + 1, dtype=torch.int64,
                       device=keys.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=keys.shape[0]), 0)
    return torch.sparse_csr_tensor(
        crow, keys[rows, lanes].long(),
        torch.ones(rows.numel(), dtype=torch.float32, device=keys.device),
        size=(keys.shape[0], n), check_invariants=False)


def compare_kernels(torch, got) -> list:
    """Each kernel against its plain version on the captured inputs."""
    from repro_torch.kernels.slab_sweep import slab_sweep, slab_sweep_ref
    from repro_torch.kernels.slab_update import (slab_commit,
                                                 slab_commit_torch,
                                                 slab_probe,
                                                 slab_probe_torch)
    results = []
    # 256 MiB, five times the L2: the update probes rows no recent kernel
    # touched, so each timed probe starts with the cache cold
    flush = torch.empty(1 << 26, dtype=torch.int32, device="cuda")

    # -- probe: every batch size the update used ------------------------------
    for B, (keys, nxt, start, dst) in sorted(got["probe"].items()):
        k = slab_probe(keys, nxt, start, dst)
        p = slab_probe_torch(keys, nxt, start, dst)
        torch.cuda.synchronize()
        err = max(int((a.long() - b.long()).abs().max()) for a, b in
                  zip(k, p))
        check(all(torch.equal(a, b) for a, b in zip(k, p)),
              f"slab_probe differs from its plain version at B={B}")
        rows = probe_rows(torch, keys, nxt, start, dst)
        results.append(dict(
            name="slab_probe", variant=f"B={B}", max_abs_err=err,
            ms=device_ms(torch, lambda: slab_probe(keys, nxt, start, dst),
                         flush=flush),
            plain_ms=time_ms(torch,
                             lambda: slab_probe_torch(keys, nxt, start, dst)),
            rows_read=rows, hits=int(k[0].sum()),
            library_ms=None,
            **bound(rows * (512 + 4) + B * (4 + 4) + B * (1 + 4 + 4),
                    rows * 128)))

    # -- commit: the delete and insert plans ------------------------------------
    for B, (keys, deg, w, *plan) in sorted(got["commit"].items()):
        outs = []
        for fn in (slab_commit, slab_commit_torch):
            kk, dd = keys.clone(), deg.clone()
            ww = None if w is None else w.clone()
            fn(kk, dd, ww, *plan)
            outs.append((kk, dd))
        torch.cuda.synchronize()
        err = max(int((outs[0][i].long() - outs[1][i].long()).abs().max())
                  for i in range(2))
        check(all(torch.equal(outs[0][i], outs[1][i]) for i in range(2)),
              f"slab_commit differs from its plain version at B={B}")
        kk, dd = keys.clone(), deg.clone()
        S, V = keys.shape[0], deg.shape[0]
        live = int(((plan[0] >= 0) & (plan[0] < S)).sum())
        n_deg = int(torch.unique(plan[3][(plan[3] >= 0)
                                         & (plan[3] < V)]).numel())
        results.append(dict(
            name="slab_commit", variant=f"B={B}", max_abs_err=err,
            ms=device_ms(torch, lambda: slab_commit(kk, dd, None, *plan)),
            plain_ms=time_ms(torch, lambda: slab_commit_torch(
                kk, dd, None, *plan)),
            live_lanes=live, library_ms=None,
            **bound(B * 5 * 4 + live * 4 + n_deg * 8, B)))

    # -- sweep: the four semirings, with and without frontier -------------------
    base = got["sweep"][("min_plus", True)]
    f_any = base["frontier"]
    keys, owner = base["keys"], base["slab_vertex"]
    S, n = keys.shape[0], base["n_vertices"]
    dist = base["values"]
    tgt = got["sweep"][("arg_min_plus", True)]["target"]
    rows_alloc = int((owner >= 0).sum())
    for semiring in ("sum", "min", "min_plus", "arg_min_plus"):
        for use_f in (False, True):
            cap = got["sweep"].get((semiring, use_f))
            values = cap["values"] if cap is not None else dist
            frontier = f_any if use_f else None
            target = tgt if semiring == "arg_min_plus" else None
            k = slab_sweep(keys, owner, values, None, frontier, target,
                           semiring=semiring, n_vertices=n)
            p = slab_sweep_ref(keys, owner, values, semiring=semiring,
                               n_vertices=n, frontier=frontier,
                               target=target)
            torch.cuda.synchronize()
            if semiring == "sum":
                err = float((k - p).abs().max())
                check(err <= SUM_RTOL * float(p.abs().max()) + 1e-30,
                      f"sum sweep off by {err}")
            else:
                err = int((k.long() - p.long()).abs().max()) \
                    if k.dtype == torch.int32 else float((k - p).abs().max())
                check(torch.equal(k, p),
                      f"{semiring} sweep differs from its plain version")
            # keys (and target) only of allocated rows; owner and output
            # of every row; values and frontier once each
            n_bytes = (rows_alloc * 512 + S * (4 + 4) + n * 4
                       + (n if use_f else 0)
                       + (rows_alloc * 4 if target is not None else 0))
            library_ms = None
            if semiring == "sum" and not use_f:
                # the same sums as one sparse product: the pool's live lanes
                # as an (S, n) CSR matrix of ones (built outside the timing)
                a = csr_of_pool(torch, keys, owner, n)
                lib = torch.mv(a, values)
                torch.cuda.synchronize()
                check(float((lib - p).abs().max())
                      <= SUM_RTOL * float(p.abs().max()) + 1e-30,
                      "the CSR product disagrees with the sum sweep")
                library_ms = device_ms(torch, lambda: torch.mv(a, values))
                del a
            results.append(dict(
                name="slab_sweep",
                variant=f"{semiring}{'+frontier' if use_f else ''}"
                        f"{' (main path)' if cap is not None else ''}",
                max_abs_err=err,
                ms=device_ms(torch, lambda: slab_sweep(
                    keys, owner, values, None, frontier, target,
                    semiring=semiring, n_vertices=n)),
                plain_ms=time_ms(torch, lambda: slab_sweep_ref(
                    keys, owner, values, semiring=semiring, n_vertices=n,
                    frontier=frontier, target=target)),
                library_ms=library_ms, rows=S, rows_allocated=rows_alloc,
                **bound(n_bytes, S * 128 * 2)))
    for r in results:
        emit({"phase": "kernels", **r})
    return results


# ----------------------------------------------------------------------------
# phase 3: serve at full size, then the self-check
# ----------------------------------------------------------------------------

def self_check(torch, np, out) -> dict:
    """Hold the served state to a static rebuild from the edge ledger."""
    from repro_torch.algorithms import bfs_tree_static, pagerank
    from repro_torch.core.worklist import pool_edges
    from repro_torch.launch.serve import EdgeLedger, pair_keys
    from repro_torch.stream import GraphStore

    store, registry, ledger = out["store"], out["registry"], out["ledger"]
    V = store.n_vertices
    dev = store.device

    # the maintained forward view holds exactly the ledger's edges
    view = pool_edges(store.forward)
    rows, lanes = torch.nonzero(view.valid, as_tuple=True)
    live = (store.forward.slab_vertex[rows].long() << 32) | \
        store.forward.keys[rows, lanes].long()
    live = torch.sort(live).values
    want = torch.from_numpy(ledger.keys.astype(np.int64)).to(dev)
    check(live.numel() == want.numel() and torch.equal(live, want),
          f"forward view holds {live.numel()} edges, ledger "
          f"{want.numel()}")
    check(store.n_edges == len(ledger), "n_edges disagrees with the ledger")

    pairs = EdgeLedger.pairs(ledger.keys)
    static = GraphStore.from_edges(V, pairs[:, 0], pairs[:, 1],
                                   hashing=False, with_symmetric=False,
                                   device=dev)
    tree = registry.read("bfs_0")
    want_tree, _ = bfs_tree_static(static.forward, 0, edge_capacity=1,
                                   g_in=static.transpose)
    check(torch.equal(tree.dist, want_tree.dist)
          and torch.equal(tree.parent, want_tree.parent),
          "maintained BFS tree differs from the static one")

    pr = registry.read("pagerank")
    want_pr, iters = pagerank(static.transpose, static.out_degree)
    l1 = float((pr - want_pr).abs().sum())
    check(l1 <= PR_L1_TOL, f"PageRank L1 distance {l1} > {PR_L1_TOL}")

    # membership: the last member request saw the final graph
    rng = np.random.default_rng(1)
    kind, req, resp, _ = out["responses"][-1]
    check(kind == "member", "the stream should end on a membership query")
    q = pair_keys(req.src, req.dst)
    check(np.array_equal(resp.payload["found"], np.isin(q, ledger.keys)),
          "membership answers disagree with the ledger")
    sample = ledger.keys[rng.choice(len(ledger), 4096, replace=False)]
    sp = EdgeLedger.pairs(sample)
    qs = np.concatenate([sp[:, 0], rng.integers(0, V, 4096)])
    qd = np.concatenate([sp[:, 1], rng.integers(0, V, 4096)])
    found = store.query(qs, qd)
    check(np.array_equal(found, np.isin(pair_keys(qs, qd), ledger.keys)),
          "membership answers disagree with the ledger")
    return {"edges": int(live.numel()), "bfs_reachable":
            int((tree.dist < 2 ** 30).sum()), "pagerank_l1": l1,
            "pagerank_static_iters": iters,
            "member_hits": int(found.sum())}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import numpy as np

    from repro_torch.kernels import runtime
    from repro_torch.launch import serve as serve_mod

    t_start = time.perf_counter()
    card = gpu_line()
    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    built = runtime.build(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": {k: round(v["seconds"], 3) for k, v in built.items()},
          "ptxas": {k: [ln.strip() for ln in v["log"].splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in built.items()}})
    print(card, flush=True)
    dev_name = torch.cuda.get_device_name(0)

    # -------------------------------------------------------------- kernels
    t0 = time.perf_counter()
    got, _ = capture_serve_inputs(torch, np, serve_mod)
    for key in (("sum", False), ("min_plus", True), ("arg_min_plus", True)):
        check(key in got["sweep"], f"main path never swept {key}")
    check(len(got["probe"]) >= 2 and len(got["commit"]) >= 2,
          "main path should probe and commit its delete and insert batches")
    results = compare_kernels(torch, got)
    del got
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0})

    # ---------------------------------------------------------------- serve
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_launches()
    out = serve_mod.main(SERVE_ARGS)
    torch.cuda.synchronize()
    launches = dict(runtime.LAUNCHES)
    emit({"phase": "serve", "boot_s": out["boot_s"],
          "serve_s": out["serve_s"], "generate_s": out["generate_s"],
          "latency": out["latency"],
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "pool": out["pool"], "kernels": launches})
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched on the main path")
    per_kind = {}
    for kind, _, _, launched in out["responses"]:
        for name, n in launched.items():
            per_kind.setdefault(kind, {}).setdefault(name, []).append(n)
    emit({"phase": "serve", "launches_per_request": per_kind})
    t0 = time.perf_counter()
    emit({"phase": "self_check", **self_check(torch, np, out),
          "seconds": time.perf_counter() - t0})

    # ------------------------------------------------------------- summary
    main_variant = {"slab_probe": "B=65536", "slab_commit": "B=65536",
                    "slab_sweep": "sum (main path)"}
    replaces = {
        "slab_probe": "src/repro/kernels/slab_update/kernel.py:81",
        "slab_commit": "src/repro/kernels/slab_update/kernel.py:160",
        "slab_sweep": "src/repro/kernels/slab_sweep/kernel.py:80"}
    source = {"slab_probe": "src/repro_torch/csrc/slab_update.cu",
              "slab_commit": "src/repro_torch/csrc/slab_update.cu",
              "slab_sweep": "src/repro_torch/csrc/slab_sweep.cu"}
    kernels = []
    for name in ("slab_probe", "slab_commit", "slab_sweep"):
        rows = [r for r in results if r["name"] == name]
        main_row = next(r for r in rows if r["variant"] == main_variant[name])
        kernels.append({
            "name": name, "route": "cuda", "source": source[name],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev_name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        sys.exit(1)
