"""Streaming analytics over the port's ``repro_torch.stream`` subsystem
(``examples/streaming_analytics.py`` on ``repro_torch``): build a
versioned GraphStore, register incremental property maintainers, push
mixed insert/delete epochs through the request pipeline, read analytics,
run a sustained churn phase under a ``MaintenancePolicy`` (slab compaction
keeps the pool dense and bounded), and round-trip the whole thing through
a checkpoint.

    PYTHONPATH=src python examples/torch_streaming_analytics.py [--device cpu]

Runs on the CUDA card (probe, commit and sweep kernels; the compaction's
census and chain-walk kernels) unless given ``--device cpu``, where the
plain PyTorch versions run; without a card ``cuda`` raises.  ``main``
returns the numbers it prints.
"""
import argparse
import tempfile

import numpy as np

from repro_torch.algorithms import (bfs_stream_property,
                                    pagerank_stream_property,
                                    wcc_stream_property)
from repro_torch.data.synth import rmat_edges
from repro_torch.stream import (GraphStore, MaintenancePolicy,
                                MembershipQuery, PropertyRead,
                                PropertyRegistry, RequestPipeline,
                                UpdateBatch)

#: the response payload keys the example prints
DETAIL = ("inserted", "deleted", "coalesced", "hits", "name")


def main(device="cuda") -> dict:
    out = {}
    rng = np.random.default_rng(7)
    V, E = 2000, 10000
    src, dst = rmat_edges(V, E, seed=7)

    # --- update plane: all views, one versioned unit -----------------------
    store = GraphStore.from_edges(V, src, dst, hashing=False,
                                  slack_slabs=2048, device=device)
    out["boot"] = {"E": store.n_edges, "version": store.version}
    print(f"[example] boot: V={V} E={store.n_edges} version={store.version}")

    # --- query plane: incremental maintainers keyed to store versions ------
    registry = PropertyRegistry(store)
    cap = store.n_edges + 16384
    registry.register(pagerank_stream_property(), policy="lazy")
    registry.register(bfs_stream_property(0, edge_capacity=cap),
                      policy="eager")
    registry.register(wcc_stream_property(), policy="lazy")
    pipeline = RequestPipeline(store, registry)

    # --- a few mixed epochs: the two updates coalesce into ONE apply -------
    ins = rng.integers(0, V, (256, 2)).astype(np.uint32)
    ins = ins[ins[:, 0] != ins[:, 1]]
    dels = np.stack([src[:64], dst[:64]], axis=1)
    responses = pipeline.run([
        UpdateBatch(ins_src=ins[:128, 0], ins_dst=ins[:128, 1],
                    del_src=dels[:, 0], del_dst=dels[:, 1]),
        UpdateBatch(ins_src=ins[128:, 0], ins_dst=ins[128:, 1]),
        PropertyRead("pagerank"),
        PropertyRead("bfs_0"),
        PropertyRead("wcc"),
        MembershipQuery(src=ins[:, 0], dst=ins[:, 1]),
    ])
    out["responses"] = []
    for r in responses:
        detail = {k: v for k, v in r.payload.items() if k in DETAIL}
        out["responses"].append({"kind": r.kind, "version": r.version,
                                 **detail})
        print(f"[example] {r.kind:9s} v{r.version} "
              f"{1e3 * r.latency_s:7.1f} ms  {detail}")

    pr = registry.read("pagerank")
    bfs_state = registry.read("bfs_0")
    labels = registry.read("wcc")
    out["pagerank_top"] = float(pr.max())
    out["bfs_reachable"] = int((bfs_state.dist.cpu().numpy() < 1e29).sum())
    out["wcc_components"] = int(
        (labels.cpu().numpy() == np.arange(V)).sum())
    print(f"[example] pagerank top={out['pagerank_top']:.5f}  "
          f"bfs reachable={out['bfs_reachable']}  "
          f"wcc components={out['wcc_components']}")

    # --- churn + maintain: sustained delete/re-insert under a policy -------
    # Without maintenance this loop only ever tombstones lanes and bumps the
    # allocator; with the policy attached, tombstone-heavy epochs trigger a
    # compaction of all views as one versioned unit (properties survive:
    # vertex ids are stable, replay skips maintenance batches).
    store.maintenance = MaintenancePolicy(tombstone_ratio=0.2)
    ledger = {(int(s), int(d)) for s, d in zip(src, dst)}
    for epoch in range(6):
        pool = np.array(sorted(ledger), np.uint32)
        di = rng.choice(len(pool), 512, replace=False)
        dels2 = pool[di]
        ins2 = rng.integers(0, V, (512, 2)).astype(np.uint32)
        ledger -= {(int(s), int(d)) for s, d in dels2}
        ledger |= {(int(s), int(d)) for s, d in ins2}
        pipeline.run([UpdateBatch(ins_src=ins2[:, 0], ins_dst=ins2[:, 1],
                                  del_src=dels2[:, 0], del_dst=dels2[:, 1])])
    st = store.pool_stats()
    out["capacity_slabs"] = st["capacity_slabs"]
    out["tombstone_ratio"] = st["tombstone_ratio"]
    out["maintenance_passes"] = store.maintenance_count
    print(f"[example] churn x6: capacity={st['capacity_slabs']} slabs  "
          f"tombstone_ratio={st['tombstone_ratio']:.3f}  "
          f"maintenance passes={store.maintenance_count}")
    out["last_maintenance"] = None
    if store.last_maintenance is not None:
        out["last_maintenance"] = store.last_maintenance.describe()
        print(f"[example] last maintenance: {out['last_maintenance']}")
    labels = registry.read("wcc")  # reads stay consistent across compactions

    # --- checkpoint round trip: same answers from the restored store -------
    with tempfile.TemporaryDirectory() as td:
        store.save(td, registry=registry)
        specs = [pagerank_stream_property(),
                 bfs_stream_property(0, edge_capacity=cap),
                 wcc_stream_property()]
        store2, registry2 = GraphStore.restore(td, specs=specs,
                                               device=device)
        out["restored_version"] = store2.version
        out["membership_identical"] = bool(np.array_equal(
            store.query(ins[:, 0], ins[:, 1]),
            store2.query(ins[:, 0], ins[:, 1])))
        out["wcc_identical"] = bool(np.array_equal(
            labels.cpu().numpy(), registry2.read("wcc").cpu().numpy()))
        print(f"[example] restored v{store2.version}: "
              f"membership identical={out['membership_identical']} "
              f"wcc identical={out['wcc_identical']}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(ap.parse_args().device)
