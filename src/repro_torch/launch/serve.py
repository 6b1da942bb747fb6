"""Serving launcher: a streaming dynamic-graph analytics service.

The request stream cycles ``update, read:pagerank, read:bfs_0, read:wcc,
member``: batched edge updates (inserts and deletes), PageRank, BFS-tree
and component reads and membership queries, served by a ``GraphStore``
(forward and transpose views, no symmetric one), a ``PropertyRegistry``
and a ``RequestPipeline`` on one device.  With ``--maintain`` (the
default) a ``MaintenancePolicy`` checks every closed epoch: once the
tombstones reach ``--tombstone-ratio`` of the occupied lanes, both views
compact (and may shrink) instead of growing for as long as the server runs.
``--shards N`` (N > 1) serves a ``ShardedGraphStore`` instead: the same
views vertex-partitioned into N shards on the one device, with the sharded
PageRank, BFS and WCC properties.  ``--checkpoint DIR`` saves the store
and its properties at the end (the unsharded store only); ``--trace``,
``--metrics`` and ``--metrics-json`` arm the telemetry plane (the metrics
output carries the kernel dispatch statistics); ``--health`` runs the SLO
burn-rate engine in the pipeline (targets from ``--slo-update-ms``) and
prints its reports; ``--evidence-dir`` writes a metrics and
flight-recorder snapshot on exit.

    python -m repro_torch.launch.serve --device cuda --vertices 1048576 \\
        --initial-edges 16777216 --batch 65536 --requests 15
    python -m repro_torch.launch.serve --device cpu --shards 4 --health \\
        --metrics
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np

_MASK32 = np.uint64(0xFFFFFFFF)


def pair_keys(src, dst) -> np.ndarray:
    """(src, dst) pairs as uint64 keys ``src << 32 | dst``."""
    return (np.asarray(src).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(dst).astype(np.uint64)


class EdgeLedger:
    """The edges present, as a sorted array of ``pair_keys``: the request
    generator's bookkeeping (the store owns the graph)."""

    def __init__(self, src, dst):
        self.keys = np.unique(pair_keys(src, dst))

    def __len__(self) -> int:
        return len(self.keys)

    @staticmethod
    def pairs(keys: np.ndarray) -> np.ndarray:
        """(n, 2) uint32 (src, dst) of ``keys``."""
        return np.stack([keys >> np.uint64(32), keys & _MASK32],
                        axis=1).astype(np.uint32)

    def update(self, deleted: np.ndarray, inserted: np.ndarray) -> None:
        """Remove the ``deleted`` keys (present, distinct), then add the
        ``inserted`` ones not yet present; binary searches on the sorted
        ledger, no re-sort of it."""
        keep = np.ones(len(self.keys), bool)
        keep[np.searchsorted(self.keys, deleted)] = False
        keys = self.keys[keep]
        new = np.unique(inserted)
        at = np.searchsorted(keys, new)
        present = keys[np.minimum(at, len(keys) - 1)] == new if len(keys) \
            else np.zeros(len(new), bool)
        self.keys = np.insert(keys, at[~present], new[~present])


def build_requests(n_vertices, initial_edges, rng, *, n_requests: int,
                   batch: int, delete_frac: float, prop_names,
                   ledger: Optional[EdgeLedger] = None):
    """Yield ``(kind, request)`` pairs, one generator step per request.

    Deletes are sampled from the ledger of present edges, sorted by
    (src, dst), so the draws are the reference generator's for the same
    ``rng``.  Pass ``ledger`` to read the edge set after the last update.
    """
    from ..stream import MembershipQuery, PropertyRead, UpdateBatch

    if ledger is None:
        ledger = EdgeLedger(*initial_edges)
    kinds = ["update"] + [f"read:{p}" for p in prop_names] + ["member"]
    V = n_vertices
    for i in range(n_requests):
        kind = kinds[i % len(kinds)]
        if kind == "update":
            n_del = int(batch * delete_frac)
            ins = rng.integers(0, V, (batch - n_del, 2)).astype(np.uint32)
            ins = ins[ins[:, 0] != ins[:, 1]]
            del_keys = ledger.keys[:0]
            if len(ledger):
                del_keys = ledger.keys[rng.choice(
                    len(ledger), min(n_del, len(ledger)), replace=False)]
            dels = EdgeLedger.pairs(del_keys)
            ledger.update(del_keys, pair_keys(ins[:, 0], ins[:, 1]))
            yield kind, UpdateBatch(ins_src=ins[:, 0], ins_dst=ins[:, 1],
                                    del_src=dels[:, 0] if len(dels) else (),
                                    del_dst=dels[:, 1] if len(dels) else ())
        elif kind.startswith("read:"):
            yield kind, PropertyRead(kind.split(":", 1)[1])
        else:
            q = rng.integers(0, V, (1024, 2)).astype(np.uint32)
            yield kind, MembershipQuery(src=q[:, 0], dst=q[:, 1])


def describe(resp, n_vertices: int) -> str:
    """One-line detail per response kind for the serve log."""
    p = resp.payload
    if resp.kind == "update":
        return f"inserted={p['inserted']} deleted={p['deleted']}"
    if resp.kind == "member":
        return f"hits={p['hits']}/{len(p['found'])}"
    if resp.kind == "property":
        v = p["value"]
        # a TreeState (dist, parent) or a vector
        v = (v[0] if isinstance(v, tuple) else v).cpu().numpy()
        if p["name"].startswith("bfs"):
            return f"reachable={int((v < 2 ** 30).sum())}"
        if p["name"] == "wcc":
            return f"components={int((v == np.arange(n_vertices)).sum())}"
        return f"top={float(v.max()):.5f}"
    return ""


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--vertices", type=int, default=20000)
    ap.add_argument("--initial-edges", type=int, default=100000)
    ap.add_argument("--requests", type=int, default=30)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--delete-frac", type=float, default=0.25,
                    help="fraction of each update batch that deletes")
    ap.add_argument("--policy", choices=["lazy", "eager"], default="lazy")
    ap.add_argument("--maintain", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="attach a MaintenancePolicy (slab compaction at "
                         "epoch close)")
    ap.add_argument("--tombstone-ratio", type=float, default=0.2,
                    help="compaction trigger: dead/occupied lanes")
    ap.add_argument("--shards", type=int, default=1,
                    help="vertex-partition the store into N shards on the "
                         "one device (ShardedGraphStore)")
    ap.add_argument("--checkpoint", default=None,
                    help="directory to snapshot the store into at the end")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="arm the telemetry plane and write a Chrome "
                         "trace-event JSON (open in Perfetto) on exit")
    ap.add_argument("--metrics", action="store_true",
                    help="arm the metrics registry and print the "
                         "counter/histogram table on exit")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="also export the metrics registry summary as JSON")
    ap.add_argument("--health", action="store_true",
                    help="run the SLO burn-rate HealthEngine inside the "
                         "pipeline and print its reports")
    ap.add_argument("--slo-update-ms", type=float, default=2000.0,
                    help="--health: update-class latency SLO (objective "
                         "0.9; member the same, property 4x)")
    ap.add_argument("--evidence-dir", default=None, metavar="DIR",
                    help="write a metrics and flight-recorder snapshot into "
                         "DIR on exit (atexit and SIGTERM)")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def _metrics_summary() -> dict:
    """The metrics registry's summary with the kernel dispatch statistics
    under ``kernels``."""
    from .. import obs
    summary = obs.get_registry().summary()
    summary["kernels"] = obs.kernel_summary()
    return summary


def _arm_evidence(evdir, log) -> None:
    """Snapshot the metrics and the flight ring into ``evdir`` at exit,
    and turn SIGTERM into an exit so that the snapshot still runs."""
    import atexit
    import pathlib
    import signal
    import sys

    from .. import obs
    from ..obs import flight
    evdir = pathlib.Path(evdir)
    snapped = []

    def snap():
        if snapped:
            return                    # atexit and SIGTERM may both call
        snapped.append(True)
        try:
            evdir.mkdir(parents=True, exist_ok=True)
            (evdir / "metrics.json").write_text(json.dumps(
                _metrics_summary(), indent=2, default=str))
            flight.export_chrome_trace(evdir / "flight_trace.json")
            (evdir / "flight_events.json").write_text(json.dumps(
                {"stats": flight.stats(), "events": flight.snapshot()},
                indent=2))
            log(f"[serve] evidence snapshot -> {evdir}")
        except Exception as e:        # evidence must never mask the exit
            log(f"[serve] evidence snapshot failed: {e}")

    atexit.register(snap)
    signal.signal(signal.SIGTERM, lambda signum, frame: sys.exit(128 + signum))


def serve(args: argparse.Namespace, *, log=print) -> dict:
    """Boot the store and registry, serve the request stream; returns the
    store, registry, ledger, per-class latencies, the health engine (or
    None) and the responses as ``(kind, request, response, kernel
    launches)``."""
    from .. import obs
    from ..algorithms import (bfs_stream_property, pagerank_stream_property,
                              wcc_stream_property)
    from ..core.device import resolve_device
    from ..data.synth import rmat_edges
    from ..kernels.runtime import LAUNCHES
    from ..stream import (GraphStore, MaintenancePolicy, PropertyRegistry,
                          RequestPipeline, ShardedGraphStore, dedup_pairs,
                          sharded_bfs_property, sharded_pagerank_property,
                          sharded_wcc_property)

    dev = resolve_device(args.device)
    if args.trace or args.metrics or args.metrics_json:
        obs.enable()
    if args.evidence_dir:
        _arm_evidence(args.evidence_dir, log)
    rng = np.random.default_rng(args.seed)
    V = args.vertices
    t_boot = time.perf_counter()
    src, dst = rmat_edges(V, args.initial_edges, seed=args.seed)
    src, dst, _ = dedup_pairs(src, dst)
    policy = (MaintenancePolicy(tombstone_ratio=args.tombstone_ratio)
              if args.maintain else None)
    if args.shards > 1:
        # the same views, vertex-partitioned; the analytics run as sharded
        # sweep super-steps
        store = ShardedGraphStore.from_edges(V, args.shards, src, dst,
                                             maintenance=policy, device=dev)
        registry = PropertyRegistry(store)
        registry.register(sharded_pagerank_property(), policy=args.policy)
        registry.register(sharded_bfs_property(0), policy=args.policy)
        registry.register(sharded_wcc_property(), policy=args.policy)
    else:
        # pagerank, bfs and wcc read only the forward and transpose views
        store = GraphStore.from_edges(
            V, src, dst, hashing=False, with_symmetric=False,
            slack_slabs=args.requests * args.batch // 64 + 512,
            maintenance=policy, device=dev)
        registry = PropertyRegistry(store)
        cap = len(src) + args.requests * args.batch + 4096
        registry.register(pagerank_stream_property(), policy=args.policy)
        registry.register(bfs_stream_property(0, edge_capacity=cap),
                          policy=args.policy)
        registry.register(wcc_stream_property(), policy=args.policy)
    boot_s = time.perf_counter() - t_boot
    log(f"[serve] boot: V={V} E={store.n_edges} shards={args.shards} "
        f"device={dev} ({boot_s:.1f}s)")
    health = None
    if args.health:
        from ..obs.health import HealthEngine, SLOTarget
        slo_s = args.slo_update_ms / 1e3
        health = HealthEngine(
            [SLOTarget("update", latency_s=slo_s, objective=0.9),
             SLOTarget("property", latency_s=4 * slo_s, objective=0.9),
             SLOTarget("member", latency_s=slo_s, objective=0.9)],
            window=128)
    pipeline = RequestPipeline(store, registry, health=health,
                               health_every=8)

    ledger = EdgeLedger(src, dst)
    lat = {}
    responses = []
    t0 = time.perf_counter()
    stream = build_requests(V, (src, dst), rng, n_requests=args.requests,
                            batch=args.batch, delete_frac=args.delete_frac,
                            prop_names=["pagerank", "bfs_0", "wcc"],
                            ledger=ledger)
    gen_s = 0.0                     # host time drawing the requests
    t_gen = time.perf_counter()
    for i, (kind, req) in enumerate(stream):
        gen_s += time.perf_counter() - t_gen
        before = dict(LAUNCHES)
        resp = pipeline.run([req])[0]
        launched = {k: n - before[k] for k, n in LAUNCHES.items()
                    if n > before[k]}
        responses.append((kind, req, resp, launched))
        lat.setdefault(resp.kind, []).append(resp.latency_s)
        obs.observe(f"serve.latency.{resp.kind}", resp.latency_s)
        log(f"[serve] req {i:03d} {kind:13s} {1e3 * resp.latency_s:8.1f}"
            f" ms  v{resp.version:<4d} {describe(resp, V)}"
            + "".join(f" {k}={n}" for k, n in launched.items()))
        if health is not None and (i + 1) % 10 == 0:
            r = health.report()
            log(f"[serve] health: {'OK' if r.healthy else 'BURNING'} "
                f"worst_burn={r.worst_burn:.2f} "
                f"({r.worst_burn_class or '-'})")
        t_gen = time.perf_counter()
    elapsed = time.perf_counter() - t0
    log(f"[serve] {args.requests} requests in {elapsed:.1f}s "
        f"({gen_s:.1f}s drawing them), store v{store.version}, "
        f"E={store.n_edges}")
    latency = {}
    for cls, xs in lat.items():
        a = np.asarray(xs)
        latency[cls] = {"n": len(a), "mean_ms": 1e3 * a.mean(),
                        "p50_ms": 1e3 * np.percentile(a, 50),
                        "p95_ms": 1e3 * np.percentile(a, 95),
                        "max_ms": 1e3 * a.max()}
        s = latency[cls]
        log(f"[serve] latency {cls:9s}: n={s['n']:<4d} "
            f"mean={s['mean_ms']:8.1f} p50={s['p50_ms']:8.1f} "
            f"p95={s['p95_ms']:8.1f} max={s['max_ms']:8.1f} ms")
    st = store.pool_stats()
    log(f"[serve] pool: capacity={st['capacity_slabs']} slabs "
        f"(next_free={st['next_free']}) live={st['live_lanes']} "
        f"tombstones={st['tombstone_lanes']} "
        f"occupancy={st['occupancy']:.3f} "
        f"chains mean={st['mean_chain']:.2f} max={st['max_chain']}")
    if args.maintain:
        rec = store.last_maintenance
        last = (f"{rec.describe()} ({1e3 * rec.duration_s:.1f} ms, "
                f"scan {1e3 * rec.scan_s:.1f} ms)" if rec
                else "never triggered")
        log(f"[serve] maintenance: {store.maintenance_count} passes, "
            f"last: {last}")
    report = None
    if health is not None:
        report = health.report()
        for line in report.render().splitlines():
            log(f"[serve] {line}")
    if args.checkpoint:
        if args.shards > 1:
            log("[serve] --checkpoint is not wired for sharded stores yet")
        else:
            path = store.save(args.checkpoint, registry=registry)
            log(f"[serve] checkpointed store+properties -> {path}")
    if args.metrics:
        log("[serve] --- metrics " + "-" * 47)
        log(obs.get_registry().render_table())
        ks = obs.kernel_summary()
        if ks:
            log("[serve] --- kernel dispatch stats " + "-" * 33)
            for key, k in sorted(ks.items()):
                steady = k["steady_s"] / max(1, k["steady_calls"])
                log(f"[serve] {key:44s} calls={k['calls']:<5d} "
                    f"compile={k['compile_s']:.3f}s "
                    f"steady={1e3 * steady:.2f}ms bytes={k['bytes']}")
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(_metrics_summary(), f, indent=2, default=str)
        log(f"[serve] metrics -> {args.metrics_json}")
    if args.trace:
        path = obs.export_chrome_trace(
            args.trace, counters=obs.get_registry().counters())
        log(f"[serve] chrome trace -> {path} "
            f"({len(obs.trace.events())} events)")
    return {"store": store, "registry": registry, "ledger": ledger,
            "responses": responses, "latency": latency, "boot_s": boot_s,
            "serve_s": elapsed, "generate_s": gen_s, "pool": st,
            "health": health, "health_report": report}


def main(argv=None) -> dict:
    return serve(parse_args(argv))


if __name__ == "__main__":
    main()
