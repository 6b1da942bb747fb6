"""The ranks of ``test_torch_mesh.py``: the sharded plane's multi-process
rendering on gloo ranks on the CPU, one process a shard.

Imported by the test (which builds the same scenario and holds the ranks'
results against the reference's ``vmap`` path and the port's stacked
rendering) and by every rank, which ``RankGroup`` starts with the
``spawn`` method.  It imports no JAX: a rank runs only the port.

Each rank writes one pickle, ``rank{r}.pkl``, into the run's directory:
a dict of host values (numpy arrays of its shard's pool leaves after
every epoch, masks, answers, iteration counts, exceptions caught).
"""
from __future__ import annotations

import os
import pickle
import sys
import traceback

import numpy as np

RATIO = 0.05
#: (name, V, S, boot edges): V % S != 0 in both CPU configurations; the
#: card tests' (``tests/test_torch_gpu.py``) run 2 gloo ranks sharing a
#: card and one NCCL rank
CONFIGS = {"s4": (203, 4, 700), "s3": (53, 3, 260),
           "card2": (2003, 2, 9000), "card1": (2003, 1, 9000)}
CPU_CONFIGS = ("s3", "s4")
#: the durability scenario: the reference's crash-recovery stream
#: (tests/test_resilience.py: V = 96, seed 23, boot edges from seed 3) on
#: S shards, a checkpoint before batch CKPT_AT, a kill in batch CRASH_AT
APPLY_SITES = ("apply.admitted", "store.capacity_grow", "apply.post_wal",
               "apply.pre_close", "apply.post_close")
CRASH_V, CRASH_RATIO = 96, 0.15
CKPT_AT, CRASH_AT, N_BATCHES = 2, 5, 8
#: planted corruptions of the audit check (``plant``)
PLANTS = ("clean", "degree", "cycle", "cross_view")


# ----------------------------------------------------------------------------
# the scenario, the same in the test and in every rank
# ----------------------------------------------------------------------------

def rand_edges(rng, n, v):
    src = rng.integers(0, v, n).astype(np.uint32)
    dst = rng.integers(0, v, n).astype(np.uint32)
    keep = src != dst
    return src[keep], dst[keep]


def boot_edges(cfg, weighted=False):
    V, S, n = CONFIGS[cfg]
    rng = np.random.default_rng(7 + weighted)
    src, dst = rand_edges(rng, n, V)
    w = (rng.uniform(0.5, 3.0, len(src)).astype(np.float32)
         if weighted else None)
    return src, dst, w


def epochs(cfg, weighted=False):
    """``(kind, ins_src, ins_dst, ins_w, del_src, del_dst)`` per epoch.
    Unweighted: a mixed epoch whose inserts are a skewed hub burst (every
    insert owned by one shard, which grows the pools), a delete-only and
    an insert-only one; the deletes reach the policy's compaction
    trigger.  Weighted: one mixed epoch of random edges."""
    V, S, _ = CONFIGS[cfg]
    rng = np.random.default_rng(11 + weighted)
    src, dst, _ = boot_edges(cfg, weighted)
    present = set(zip(src.tolist(), dst.tolist()))
    kinds = (["mixed"] if weighted
             else ["skewed_grow", "delete_only", "insert_only"])
    out = []
    for kind in kinds:
        if kind == "skewed_grow":
            hubs = np.array([1, 1 + S, 1 + 2 * S], np.uint32) % V
            s = np.repeat(hubs, 3 * V)
            d = np.resize(rng.permutation(V).astype(np.uint32), len(s))
        else:
            s, d = rand_edges(rng, max(24, V // 2), V)
        keep = s != d
        s, d = s[keep], d[keep]
        if kind == "delete_only":
            s = d = np.zeros(0, np.uint32)
        w = (rng.uniform(0.5, 3.0, len(s)).astype(np.float32)
             if weighted else None)
        pool = np.array(sorted(present), np.uint32)
        n_del = 0 if kind == "insert_only" else min(len(pool), V // 5)
        dels = pool[rng.choice(len(pool), n_del, replace=False)] \
            if n_del else np.zeros((0, 2), np.uint32)
        present -= {(int(a), int(b)) for a, b in dels}
        present |= set(zip(s.tolist(), d.tolist()))
        out.append((kind, s, d, w, dels[:, 0].copy(), dels[:, 1].copy()))
    return out


def queries(cfg, e):
    V = CONFIGS[cfg][0]
    rng = np.random.default_rng(100 + e)
    q = rng.integers(0, V, (61, 2)).astype(np.uint32)
    src, dst, _ = boot_edges(cfg)
    q[:20, 0], q[:20, 1] = src[:20], dst[:20]
    return q


def route_batches(cfg):
    """Batches for the routing check: ``(name, src, dst, w, cap)``, a
    multiple of S long (INVALID tail padding included), random, skewed
    onto one owner, and undersized caps."""
    V, S, _ = CONFIGS[cfg]
    rng = np.random.default_rng(5)
    out = []
    for name, n, cap, skew, weighted in (("random", 12 * S, 12, False, True),
                                         ("random_small", 12 * S, 2, False,
                                          False),
                                         ("skewed", 16 * S, 16, True, True),
                                         ("skewed_small", 16 * S, 3, True,
                                          False)):
        s = rng.integers(0, V, n).astype(np.int64)
        if skew:
            s = (rng.integers(0, V // S, n) * S + 2) % V
        d = rng.integers(0, V, n).astype(np.int64)
        s[-5:] = d[-5:] = 0xFFFFFFFF              # the INVALID tail
        w = rng.uniform(0.5, 2.0, n).astype(np.float32) if weighted else None
        out.append((name, s.astype(np.uint32), d.astype(np.uint32), w, cap))
    return out


def or_partials(S):
    """``(S, 9)`` partial masks, row ``k`` rank ``k``'s."""
    import torch
    m = torch.zeros(S, 9, dtype=torch.bool)
    for k in range(S):
        m[k, k + 1] = True
    m[0, 0] = True
    return m


def op_batches(cfg):
    """Sharded ops on an empty graph: ``(insert src, dst, delete pairs,
    queries, mixed-epoch (src, dst, dels))``."""
    V, S, _ = CONFIGS[cfg]
    rng = np.random.default_rng(3)
    s = (rng.integers(0, V // S, 40).astype(np.uint32) * S + 1) % V
    d = rng.integers(0, V, 40).astype(np.uint32)
    pairs = np.array(sorted(set(zip(s.tolist(), d.tolist()))), np.uint32)
    dels = np.concatenate([pairs[:10], [[7, 9]]]).astype(np.uint32)
    q = rng.integers(0, V, (41, 2)).astype(np.uint32)
    q[:10] = pairs[:10]
    ms, md = rand_edges(rng, 30, V)
    return s, d, dels, q, (ms, md, pairs[10:16])


def crash_stream():
    """``(ins_src, ins_dst, del_src, del_dst)`` per batch: fixed shapes."""
    rng = np.random.default_rng(23)
    return [tuple(rng.integers(0, CRASH_V, n).astype(np.uint32)
                  for n in (60, 60, 12, 12)) for _ in range(N_BATCHES)]


def crash_store(stream_mod, n_shards, **kw):
    rng = np.random.default_rng(3)
    src = rng.integers(0, CRASH_V, 400).astype(np.uint32)
    dst = rng.integers(0, CRASH_V, 400).astype(np.uint32)
    return stream_mod.ShardedGraphStore.from_edges(
        CRASH_V, n_shards, src, dst,
        maintenance=stream_mod.MaintenancePolicy(tombstone_ratio=CRASH_RATIO),
        **kw)


def plant(kind, store):
    """One corruption of a port stacked store's forward view (shard 2's
    degree or chain, or a key of shard 1), as ``test_torch_sharded.py``
    plants it; the audit arguments that find it."""
    import dataclasses
    sg = store.views["forward"]
    g = sg.graphs
    if kind == "clean":
        return {}
    if kind == "degree":
        deg = g.degree.clone()
        deg[2, 0] += 1
        graphs = dataclasses.replace(g, degree=deg)
        kw = dict(cross_view=False)
    elif kind == "cycle":
        nxt = g.next_slab.clone()
        nxt[2, 3] = 3                         # a self-loop chain
        graphs = dataclasses.replace(g, next_slab=nxt)
        kw = dict(views=["forward"], cross_view=False)
    else:
        keys = g.keys.clone()
        keys[1, 0, 0] = 7
        graphs = dataclasses.replace(g, keys=keys)
        kw = dict(views=["forward", "transpose", "symmetric"])
    store._views["forward"] = dataclasses.replace(sg, graphs=graphs)
    return kw


def report_of(report) -> dict:
    """An InvariantReport's contents but its wall-clock duration."""
    return {"ok": report.ok, "checks_run": report.checks_run,
            "views": tuple(report.views),
            "violations": [(v.view, v.check, v.detail, v.count)
                           for v in report.violations]}


def wal_files(wal_dir) -> dict:
    """``{segment name: bytes}`` of a WAL directory."""
    return {name: open(os.path.join(wal_dir, name), "rb").read()
            for name in sorted(os.listdir(wal_dir))
            if name.startswith("wal-")}


def pipeline_requests(stream_mod, cfg):
    V = CONFIGS[cfg][0]
    src, dst, _ = boot_edges(cfg)
    s, d = rand_edges(np.random.default_rng(9), 40, V)
    return [
        stream_mod.UpdateBatch(ins_src=s, ins_dst=d, del_src=src[:9],
                               del_dst=dst[:9]),
        stream_mod.PropertyRead("bfs_0"), stream_mod.PropertyRead("wcc"),
        stream_mod.PropertyRead("pagerank"),
        stream_mod.MembershipQuery(src=src[:30], dst=dst[:30]),
        stream_mod.NeighborsQuery(vertices=[0, 1, 2, 5, V - 1]),
        stream_mod.UpdateBatch(ins_src=[2], ins_dst=[4]),
        stream_mod.PropertyRead("wcc"), stream_mod.PropertyRead("triangles")]


def payload_of(resp):
    """A pipeline response's payload as host values."""
    import torch
    out = {}
    for k, v in resp.payload.items():
        if isinstance(v, torch.Tensor):
            v = v.cpu().numpy()
        elif hasattr(v, "dist"):                 # a TreeState
            v = (v.dist.cpu().numpy(), v.parent.cpu().numpy())
        out[k] = v
    return out


def graph_leaves(graphs) -> dict:
    """Every tensor field of a (stacked) SlabGraph as numpy copies (the
    engine writes the pools in place)."""
    from repro_torch.core.slab_graph import FIELDS
    return {f: None if getattr(graphs, f) is None
            else getattr(graphs, f).cpu().numpy().copy() for f in FIELDS}


def store_leaves(store) -> dict:
    return {name: graph_leaves(sg.graphs) for name, sg in store.views.items()}


# ----------------------------------------------------------------------------
# the rank
# ----------------------------------------------------------------------------

def _ids(a, n=None):
    """``_torch_port.ids`` (that module imports JAX, which a rank must
    not): host ids as an int32 bit-pattern tensor padded with INVALID."""
    import torch
    a = np.asarray(a, dtype=np.int64).astype(np.uint32)
    n = len(a) if n is None else n
    out = np.full(n, 0xFFFFFFFF, np.uint32)
    out[:len(a)] = a
    return torch.from_numpy(out.view(np.int32).copy())


def _raises(fn, exc=ValueError) -> str:
    try:
        fn()
    except exc as e:
        return f"{type(e).__name__}: {e}"
    return ""


def _collectives(res, cfg, mesh):
    import torch
    from repro_torch.distributed import collectives as C
    V, S, _ = CONFIGS[cfg]
    group, r = mesh.get_group("shard"), mesh.get_local_rank("shard")
    stacked = torch.arange(S * S * 3 * 2, dtype=torch.int32).reshape(
        S, S, 3, 2)
    res["exchange"] = C.exchange_buckets(stacked[r], group).numpy()
    n_local = -(-V // S)
    loc = torch.arange(S * n_local).reshape(S, n_local) * 3 - 7
    res["gather"] = C.gather_interleaved(loc[r], V, group).numpy()
    res["or"] = C.or_across_shards(or_partials(S)[r], group).numpy()
    x = torch.tensor([r, 10 - r], dtype=torch.int64)
    res["max"] = C.max_across_shards(x, group).numpy()
    res["sum"] = C.sum_across_shards(x, group).numpy()
    res["ring"] = [t.numpy() for t in C.ring_shift(
        [torch.full((3,), r, dtype=torch.int32), x], group)]


def _routing(res, cfg, mesh):
    import torch
    from repro_torch.distributed import sharded_graph as tsg
    V, S, _ = CONFIGS[cfg]
    r = mesh.get_local_rank("shard")
    out = {}
    for name, s, d, w, cap in route_batches(cfg):
        n = len(s) // S
        blk = slice(r * n, (r + 1) * n)
        got = tsg.route_exchange(
            _ids(s)[blk], _ids(d)[blk],
            None if w is None else torch.from_numpy(w)[blk], n_shards=S,
            cap=cap, mesh=mesh)
        out[name] = tuple(None if t is None else t.numpy() for t in got)
    res["route"] = out


def _ops(res, cfg, mesh):
    from repro_torch.distributed import sharded_graph as tsg
    V, S, _ = CONFIGS[cfg]
    s, d, dels, q, (ms, md, mdel) = op_batches(cfg)
    out = {}
    for cap in (None, 1):
        g = tsg.place_on_mesh(tsg.shard_empty(
            V, S, capacity_slabs_per_shard=64, device="cpu"), mesh)
        g, im = tsg.insert_edges_sharded(g, _ids(s), _ids(d), cap=cap)
        g, dm = tsg.delete_edges_sharded(g, _ids(dels[:, 0]),
                                         _ids(dels[:, 1]), cap=cap)
        qm = tsg.query_edges_sharded(g, _ids(q[:, 0]), _ids(q[:, 1]),
                                     cap=cap)
        g, ai, ad = tsg.apply_update_sharded(
            g, _ids(ms), _ids(md), None, _ids(mdel[:, 0]), _ids(mdel[:, 1]),
            cap=cap)
        pools = graph_leaves(g.graphs)
        g = tsg.ensure_capacity_sharded(g, 200)
        out[cap] = {"ins": im.numpy(), "del": dm.numpy(),
                    "query": qm.numpy(), "apply_ins": ai.numpy(),
                    "apply_del": ad.numpy(), "pools": pools,
                    "grown": graph_leaves(g.graphs)}
    res["ops"] = out


def _store(res, cfg, mesh, run_dir, weighted):
    from repro_torch import stream as tstream
    from repro_torch.stream import sharded_store as tss
    V, S, _ = CONFIGS[cfg]
    tag = "w" if weighted else "u"
    store, _ = tstream.ShardedGraphStore.restore(
        os.path.join(run_dir, f"boot_{tag}"), device="cpu",
        maintenance=tstream.MaintenancePolicy(tombstone_ratio=RATIO))
    store.place_on_mesh(mesh)
    assert store._mode() == "shard_map"
    log = [{"pools": store_leaves(store)}]
    reg = None
    if not weighted:
        reg = tstream.PropertyRegistry(store)
        reg.register(tss.sharded_pagerank_property())
        reg.register(tss.sharded_bfs_property(0))
        reg.register(tss.sharded_wcc_property())
        reg.register(tss.sharded_triangle_property())
    from repro_torch import obs
    obs.reset()
    obs.enable()                     # one update_shards dispatch an epoch
    for e, (kind, s, d, w, ds, dd) in enumerate(epochs(cfg, weighted)):
        b = store.apply(s, d, w, ds, dd)
        if e == 0:
            summary = obs.kernel_summary()
            obs.disable()
            obs.reset()
        q = queries(cfg, e)
        row = {"kind": kind, "version": store.version,
               "n_inserted": b.n_inserted, "n_deleted": b.n_deleted,
               "ins_mask": None if b.ins_mask is None
               else b.ins_mask.numpy(),
               "del_mask": None if b.del_mask is None
               else b.del_mask.numpy(),
               "maintenance_count": store.maintenance_count,
               "pools": store_leaves(store),
               "query": store.query(q[:, 0], q[:, 1]),
               "n_edges": store.n_edges,
               "out_degree": store.out_degree.numpy()}
        if reg is not None and e in (0, 2):
            row["props"] = {name: reg.read(name).numpy()
                            for name in ("pagerank", "bfs_0", "wcc",
                                         "triangles")}
        log.append(row)
    out = {"epochs": log, "recompile_count": store.recompile_count,
           "update_shards_calls": sum(
               k["calls"] for k in summary.values()
               if k["family"] == "slab_update"
               and k["op"] == "update_shards"),
           "meta": store._resilience_meta(),
           "events": [{k: v for k, v in ev.items() if k != "duration_s"}
                      for ev in store.maintenance_events],
           "pool_stats": store.pool_stats(chains=True)}
    if not weighted:
        from repro_torch.distributed import sharded_graph as tsg
        tsg.reset_fix_stats()
        lab, it_w = tsg.wcc_sharded(store.symmetric,
                                    rows=store.sweep_rows("symmetric"))
        dist_, it_b = tsg.bfs_sharded(store.transpose, src=0)
        pr, it_p = tsg.pagerank_sharded(store.transpose, store.out_degree,
                                        rows=store.sweep_rows("transpose"))
        out["analytics"] = {"wcc": lab.numpy(), "bfs": dist_.numpy(),
                            "pagerank": pr.numpy(),
                            "iterations": (it_w, it_b, it_p),
                            "fix_stats": dict(tsg.FIX_STATS)}
        out["triangles"] = tsg.triangles_sharded(store.symmetric)
        out["in_degree"] = store.in_degree.numpy()
        nb = store.neighbors([0, 1, 2, 5, V - 1])
        out["neighbors"] = (nb.src.numpy(), nb.dst.numpy(),
                            nb.weight.numpy(), int(nb.size),
                            bool(nb.overflow))
        resps = tstream.RequestPipeline(store, reg).run(
            pipeline_requests(tstream, cfg))
        out["pipeline"] = [(p.kind, p.version, payload_of(p))
                           for p in resps]
        out["errors"] = {
            "audit": _raises(lambda: out.setdefault(
                "audit", report_of(store.audit())), Exception),
            "attach_wal": _raises(lambda: store.attach_wal(None), Exception),
            "vmap": _raises(lambda: tsg.wcc_sharded(store.symmetric,
                                                    dispatch="vmap")),
            "other_shard": _raises(lambda: tsg.shard_slice(
                store.forward, (mesh.get_local_rank("shard") + 1) % S))}
        # a forced compaction clears the sticky caps and the host bounds
        # (as on the stacked store), then the shards go to one checkpoint
        store.maintain("compact")
        out["compact_pools"] = store_leaves(store)
        out["saved"] = store.save(os.path.join(run_dir, "mesh_ckpt"),
                                  registry=reg)
    res[f"store_{tag}"] = out


def _elastic(res, cfg, mesh, run_dir):
    """The reference's checkpoint (its stacked store as booted) restored
    onto the mesh, then the first epoch."""
    from repro_torch import stream as tstream
    store, _ = tstream.ShardedGraphStore.restore(
        os.path.join(run_dir, "ref_ckpt"), device="cpu",
        maintenance=tstream.MaintenancePolicy(tombstone_ratio=RATIO))
    store.place_on_mesh(mesh)
    restored = store_leaves(store)
    kind, s, d, w, ds, dd = epochs(cfg)[0]
    b = store.apply(s, d, w, ds, dd)
    res["elastic"] = {"restored": restored, "after": store_leaves(store),
                      "n": (b.n_inserted, b.n_deleted)}


def _durability(res, cfg, mesh, run_dir):
    """The WAL and audits on the mesh: the unweighted scenario journaled
    (rank 0 writes, one segment a record) and audited every epoch, then a
    save that truncates the WAL; recovery from a kill at each apply site;
    audits of clean and planted pools; a failure on one rank."""
    import torch
    import torch.distributed as dist

    from repro_torch import resilience as rz
    from repro_torch import stream as tstream
    from repro_torch.resilience import faults
    from repro_torch.stream import sharded_store as tss
    V, S, _ = CONFIGS[cfg]
    me = mesh.get_local_rank("shard")
    group = mesh.get_group("shard")
    policy = tstream.MaintenancePolicy(tombstone_ratio=RATIO)
    out = {}

    # -- WAL and audits over the scenario, then the save's truncation
    store, _ = tstream.ShardedGraphStore.restore(
        os.path.join(run_dir, "boot_u"), device="cpu", maintenance=policy)
    wal_dir = os.path.join(run_dir, "mesh_wal")
    store.attach_wal(rz.WriteAheadLog(wal_dir, segment_records=1))
    store.attach_audits(rz.AuditPolicy(every=1))
    store.place_on_mesh(mesh)
    for kind, s, d, w, ds, dd in epochs(cfg):
        store.apply(s, d, w, ds, dd)
    out["audit_events"] = [{k: v for k, v in ev.items() if k != "duration_s"}
                           for ev in store.audit_events]
    dist.barrier(group=group)
    out["wal"] = wal_files(wal_dir)
    store.save(os.path.join(run_dir, "mesh_wal_ckpt"))
    out["wal_after_save"] = wal_files(wal_dir)
    out["appended"] = store.wal.appended
    store.wal.close()

    # -- a kill at each apply site, recovered and placed again
    batches = crash_stream()
    spec = [tss.sharded_pagerank_property()]
    for site in APPLY_SITES:
        base = os.path.join(run_dir, "crash_" + site)
        ck, wd = os.path.join(base, "ck"), os.path.join(base, "wal")
        store = crash_store(tstream, S, device="cpu").place_on_mesh(mesh)
        store.attach_wal(rz.WriteAheadLog(wd))
        reg = tstream.PropertyRegistry(store)
        reg.register(spec[0])
        crashed, versions = "", []
        try:
            for t, (i_s, i_d, d_s, d_d) in enumerate(batches):
                if t == CKPT_AT:
                    store.save(ck, registry=reg)
                if t == CRASH_AT:
                    with faults.inject(rz.FaultSpec(site, at=1)):
                        store.apply(i_s, i_d, None, d_s, d_d)
                else:
                    store.apply(i_s, i_d, None, d_s, d_d)
                versions.append(store.version)
        except rz.InjectedCrash as e:
            crashed = str(e)
        store.wal.close()
        dist.barrier(group=group)      # rank 0's bundle is on disk
        store2, reg2, report = rz.recover(
            ck, wd, store_cls=tstream.ShardedGraphStore, specs=spec,
            maintenance=tstream.MaintenancePolicy(
                tombstone_ratio=CRASH_RATIO),
            wal=rz.WriteAheadLog(wd), device="cpu")
        replay_version = store2.version
        store2.place_on_mesh(mesh)
        # the WAL replayed the killed batch when recovery passed the version
        # before it; else the batch is fed again
        resume = CRASH_AT + int(store2.version > versions[CRASH_AT - 1])
        for i_s, i_d, d_s, d_d in batches[resume:]:
            store2.apply(i_s, i_d, None, d_s, d_d)
        pr = reg2.read("pagerank")
        out[site] = {"crashed": crashed, "resume": resume,
                     "checkpoint_version": report.checkpoint_version,
                     "replayed": report.replayed,
                     "replay_version": replay_version,
                     "anomalies": report.anomalies,
                     "crash_reason": report.crash_reason,
                     "version": store2.version,
                     "pools": store_leaves(store2),
                     "meta": store2._resilience_meta(),
                     "maintenance_count": store2.maintenance_count,
                     "pagerank_finite": bool(torch.isfinite(pr).all()),
                     "wal_appended": store2.wal.appended}
        store2.wal.close()

    # -- audits: clean pools and one corruption in one rank's shard
    audits = {}
    for kind in PLANTS:
        store, _ = tstream.ShardedGraphStore.restore(
            os.path.join(run_dir, "boot_u"), device="cpu")
        kw = plant(kind, store)
        store.place_on_mesh(mesh)
        audits[kind] = report_of(rz.audit_store(store, **kw))
    out["audits"] = audits

    # -- a failure on rank 1 alone: every rank raises; an allocation
    # failure rolls rank 0's record back, a kill keeps it
    wd = os.path.join(run_dir, "failure_wal")
    store = crash_store(tstream, S, device="cpu").place_on_mesh(mesh)
    store.attach_wal(rz.WriteAheadLog(wd))
    store.apply(*batches[0][:2], None, *batches[0][2:])
    raised = {}
    for name, spec_ in (("oom", rz.FaultSpec("apply.pre_close",
                                             kind=faults.OOM, at=1)),
                        ("kill", rz.FaultSpec("apply.post_close", at=1))):
        i_s, i_d, d_s, d_d = batches[1 if name == "oom" else 2]
        try:
            with faults.inject(*([spec_] if me == 1 else [])):
                store.apply(i_s, i_d, None, d_s, d_d)
            raised[name] = ""
        except BaseException as e:      # every rank must raise
            raised[name] = type(e).__name__
        raised[name + "_appended"] = store.wal.appended
    store.wal.close()
    out["one_rank"] = raised
    res["durability"] = out


def _dispatch_errors(res, cfg, mesh):
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed import sharded_graph as tsg
    V, S, _ = CONFIGS[cfg]
    g = tsg.shard_empty(V, S + 1, capacity_slabs_per_shard=64, device="cpu")
    res["wrong_size"] = _raises(lambda: tsg.place_on_mesh(g, mesh))
    other = DeviceMesh("cpu", torch.arange(S), mesh_dim_names=("x",))
    g = tsg.shard_empty(V, S, capacity_slabs_per_shard=64, device="cpu")
    res["wrong_axis"] = _raises(lambda: tsg.place_on_mesh(g, other))


def mesh_rank(rank: int, world: int, cfg: str, run_dir: str) -> None:
    """One rank: every check of the configuration, results to
    ``rank{rank}.pkl``; an exception is recorded and exits 1."""
    import torch
    torch.set_num_threads(1)          # S ranks share the host's cores
    res = {"rank": rank}
    code = 0
    try:
        from repro_torch.distributed.ranks import (close_shard_mesh,
                                                   init_shard_mesh)
        mesh = init_shard_mesh(rank, world,
                               init_file=os.path.join(run_dir, "rdzv"),
                               backend="gloo", device="cpu")
        try:
            _collectives(res, cfg, mesh)
            _routing(res, cfg, mesh)
            _ops(res, cfg, mesh)
            _store(res, cfg, mesh, run_dir, weighted=False)
            _store(res, cfg, mesh, run_dir, weighted=True)
            _elastic(res, cfg, mesh, run_dir)
            _durability(res, cfg, mesh, run_dir)
            _dispatch_errors(res, cfg, mesh)
        finally:
            close_shard_mesh()
    except BaseException:
        res["error"] = traceback.format_exc()
        code = 1
    res["jax_imported"] = "jax" in sys.modules
    with open(os.path.join(run_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    sys.exit(code)


def card_rank(rank: int, world: int, backend: str, cfg: str,
              run_dir: str) -> None:
    """One rank of a card test: ``backend`` ranks on card 0 (gloo ranks
    share it), the unweighted scenario's store restored and placed, its
    epochs, analytics and triangle count; results to ``rank{rank}.pkl``."""
    import torch
    res = {"rank": rank}
    code = 0
    try:
        from repro_torch import stream as tstream
        from repro_torch.distributed import sharded_graph as tsg
        from repro_torch.distributed.ranks import (close_shard_mesh,
                                                   init_shard_mesh)
        from repro_torch.kernels import runtime
        mesh = init_shard_mesh(rank, world,
                               init_file=os.path.join(run_dir, "rdzv"),
                               backend=backend, device="cuda:0")
        try:
            store, _ = tstream.ShardedGraphStore.restore(
                os.path.join(run_dir, "boot_u"), device="cpu",
                maintenance=tstream.MaintenancePolicy(tombstone_ratio=RATIO))
            store.place_on_mesh(mesh)
            runtime.reset_launches()
            log = [store_leaves(store)]
            for kind, s, d, w, ds, dd in epochs(cfg):
                store.apply(s, d, w, ds, dd)
                log.append(store_leaves(store))
            res["epochs"] = log
            res["device"] = str(store.device)
            res["wcc"] = tsg.wcc_sharded(store.symmetric)[0].cpu().numpy()
            res["bfs"] = tsg.bfs_sharded(store.transpose,
                                         src=0)[0].cpu().numpy()
            res["pagerank"] = tsg.pagerank_sharded(
                store.transpose, store.out_degree)[0].cpu().numpy()
            res["triangles"] = int(tsg.triangles_sharded(store.symmetric))
            res["launches"] = dict(runtime.LAUNCHES)
        finally:
            close_shard_mesh()
    except BaseException:
        res["error"] = traceback.format_exc()
        code = 1
    with open(os.path.join(run_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    sys.exit(code)


def card_durable_rank(rank: int, world: int, backend: str, cfg: str,
                      run_dir: str) -> None:
    """One rank of the card's durability test: the unweighted scenario's
    store restored, a WAL and audits every epoch attached, placed on card
    0; the first epoch, a save, a kill at ``apply.post_wal`` in the
    second, ``recover`` onto the card and ``place_on_mesh`` again, the
    last epoch.  Results to ``rank{rank}.pkl``."""
    import torch
    res = {"rank": rank}
    code = 0
    try:
        from repro_torch import resilience as rz
        from repro_torch import stream as tstream
        from repro_torch.distributed.ranks import (close_shard_mesh,
                                                   init_shard_mesh)
        from repro_torch.resilience import faults
        mesh = init_shard_mesh(rank, world,
                               init_file=os.path.join(run_dir, "rdzv"),
                               backend=backend, device="cuda:0")
        policy = tstream.MaintenancePolicy(tombstone_ratio=RATIO)
        wd, ck = os.path.join(run_dir, "wal"), os.path.join(run_dir, "ck")
        try:
            store, _ = tstream.ShardedGraphStore.restore(
                os.path.join(run_dir, "boot_u"), device="cpu",
                maintenance=policy)
            store.attach_wal(rz.WriteAheadLog(wd))
            store.attach_audits(rz.AuditPolicy(every=1))
            store.place_on_mesh(mesh)
            (_, s0, d0, w0, ds0, dd0), (_, s1, d1, w1, ds1, dd1), \
                (_, s2, d2, w2, ds2, dd2) = epochs(cfg)
            store.apply(s0, d0, w0, ds0, dd0)
            store.save(ck)
            try:
                with faults.inject(rz.FaultSpec("apply.post_wal", at=1)):
                    store.apply(s1, d1, w1, ds1, dd1)
            except rz.InjectedCrash:
                res["killed"] = True
            res["audits"] = [report_of_event(ev) for ev in store.audit_events]
            store.wal.close()
            del store
            back, _, report = rz.recover(
                ck, wd, store_cls=tstream.ShardedGraphStore,
                maintenance=policy, wal=rz.WriteAheadLog(wd), device="cuda")
            res["replayed"] = report.replayed
            back.attach_audits(rz.AuditPolicy(every=1))
            back.place_on_mesh(mesh)
            res["device"] = str(back.device)
            back.apply(s2, d2, w2, ds2, dd2)
            res["audits"] += [report_of_event(ev)
                              for ev in back.audit_events]
            res["leaves"] = store_leaves(back)
            res["version"] = back.version
            back.wal.close()
        finally:
            close_shard_mesh()
    except BaseException:
        res["error"] = traceback.format_exc()
        code = 1
    with open(os.path.join(run_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    sys.exit(code)


def report_of_event(ev: dict) -> dict:
    """An audit event but its wall-clock duration."""
    return {k: v for k, v in ev.items() if k != "duration_s"}


def diverging_rank(rank: int, world: int, run_dir: str) -> None:
    """Rank 0 waits in a collective that rank 1 never joins (rank 1 waits
    in a sleep): the group hangs until its parent's deadline."""
    import time

    import torch
    import torch.distributed as dist

    from repro_torch.distributed.ranks import init_shard_mesh
    init_shard_mesh(rank, world, init_file=os.path.join(run_dir, "rdzv"),
                    backend="gloo", device="cpu")
    if rank == 0:
        dist.all_reduce(torch.ones(1))
    time.sleep(600)


def load_results(run_dir: str, world: int) -> list:
    out = []
    for r in range(world):
        with open(os.path.join(run_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def grad_rank(rank: int, world: int, run_dir: str) -> None:
    """One rank of ``test_torch_optimizer.py``'s compressor test: its
    gradient tree and residual from ``job.pkl``, ``compressed_psum`` and
    ``reduce_scatter_grads`` over the gloo group; results to
    ``rank{rank}.pkl``."""
    import torch
    torch.set_num_threads(1)
    res = {"rank": rank}
    code = 0
    try:
        from repro_torch.distributed import collectives as C
        from repro_torch.distributed.ranks import (close_shard_mesh,
                                                   init_shard_mesh)
        with open(os.path.join(run_dir, "job.pkl"), "rb") as f:
            job = pickle.load(f)
        init_shard_mesh(rank, world, init_file=os.path.join(run_dir, "rdzv"),
                        backend="gloo", device="cpu")
        try:
            grads = {k: torch.from_numpy(v) for k, v in
                     job["grads"][rank].items()}
            resid = {k: torch.from_numpy(v) for k, v in
                     job["res"][rank].items()}
            mean, new_res = C.compressed_psum(grads, resid)
            rs = C.reduce_scatter_grads(grads)
            res.update(mean={k: v.numpy() for k, v in mean.items()},
                       res={k: v.numpy() for k, v in new_res.items()},
                       rs={k: v.numpy() for k, v in rs.items()})
        finally:
            close_shard_mesh()
    except BaseException:
        res["error"] = traceback.format_exc()
        code = 1
    with open(os.path.join(run_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    sys.exit(code)
