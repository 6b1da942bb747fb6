"""Port parity for the sharded plane's multi-process rendering: gloo ranks
on the CPU, one process a shard, against the reference's ``vmap`` path
(``repro.distributed.sharded_graph``, ``repro.stream.sharded_store``) and
the port's stacked rendering.

Two configurations, both with ``V % S != 0``: V = 203 on 4 ranks and V =
53 on 3.  Each spawns its ranks once (``_torch_mesh_ranks.mesh_rank``);
while they run, this process drives the reference's and the port's
stacked stores through the same scenario, then reads the ranks' results:

* the collective forms of the exchanges equal their stacked forms;
* ``route_exchange``'s buckets, ``origin`` and overflow witness equal the
  stacked routing of each source block after the exchange, for random and
  skewed batches and undersized caps; the sharded ops equal the stacked
  ones (and the reference's) with growing caps;
* the store over mixed, skewed, growing, delete-only, insert-only and
  weighted epochs with a compaction on the policy's trigger: every pool
  leaf of every view, ``n_inserted``, ``n_deleted`` and the masks equal
  the reference's and the stacked store's after every epoch; the host
  accounting agrees;
* queries equal the unsharded store's; WCC, BFS and the triangle count
  are bit-equal, PageRank bit-equal to the stacked rendering and within
  2e-5 of the reference, with equal iteration counts on every rank;
  properties, the pipeline and ``neighbors`` answer as the stacked store;
* a mesh store's checkpoint equals the stacked store's (leaves byte for
  byte, the manifest key for key but the save's wall clock); a reference
  checkpoint restores onto the mesh;
* durability on the mesh: the WAL rank 0 writes is byte-equal to the
  stacked store's, before and after a save truncates it, and the audits
  of every epoch equal the stacked store's; a kill at each of the five
  apply sites, ``recover`` (stacked) and ``place_on_mesh`` give pools equal
  to the reference's and the stacked store's uninterrupted twins; audits
  of clean and planted pools equal the stacked store's word for word; a
  failure on one rank raises on every rank, rolling the record back
  unless it was a kill;
* dispatch errors raise ``ValueError``; no rank imports JAX; a diverging
  rank fails its group within the group's deadline.

Under pytest-xdist the module runs on one worker with ``--dist loadfile``
(one file) or ``--dist loadgroup`` (one ``xdist_group``), so each
configuration's ranks spawn once; other modes build the module fixture
once a worker.
"""
import os
import time

import jax
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as M
from _torch_port import ids, jax_fields, np_of

from repro import stream as jstream
from repro.distributed import sharded_graph as jsg
from repro_torch import stream as tstream
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharded_graph as tsg
from repro_torch.distributed.ranks import RankGroup
from repro_torch.stream import sharded_store as tss

pytestmark = pytest.mark.xdist_group("torch_mesh")

PR_ATOL = 2e-5
#: the parent's deadline for a configuration's ranks (they take ~5-10 s)
DEADLINE_S = 240
PROPS = ("pagerank", "bfs_0", "wcc", "triangles")


def _leaves_of_ref(store) -> dict:
    """Host copies (the reference's next apply donates its buffers)."""
    return {name: {f: None if a is None else a.copy()
                   for f, a in jax_fields(sg.graphs).items()}
            for name, sg in store.views.items()}


def _stack_ranks(per_rank) -> dict:
    """Per-rank ``{view: {field: (1, ...)}}`` to the stacked layout."""
    return {view: {f: None if per_rank[0][view][f] is None
                   else np.concatenate([r[view][f] for r in per_rank])
                   for f in per_rank[0][view]}
            for view in per_rank[0]}


def assert_leaves_equal(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for view in want:
        for f, a in want[view].items():
            b = got[view][f]
            if a is None:
                assert b is None, f"{what} {view}.{f}"
                continue
            assert b.dtype == a.dtype and b.shape == a.shape, \
                f"{what} {view}.{f}: {b.dtype}{b.shape} vs {a.dtype}{a.shape}"
            assert np.array_equal(b, a), f"{what} {view}.{f}"


# ============================================================================
# the stacked twins: the reference's vmap store and the port's stacked one
# ============================================================================

def _twin_store(cfg, weighted):
    V, S, _ = M.CONFIGS[cfg]
    s, t, w = M.boot_edges(cfg, weighted)
    pol = dict(tombstone_ratio=M.RATIO)
    ref = jstream.ShardedGraphStore.from_edges(
        V, S, s, t, w, maintenance=jstream.MaintenancePolicy(**pol))
    port = tstream.ShardedGraphStore.from_edges(
        V, S, s, t, w, maintenance=tstream.MaintenancePolicy(**pol),
        device="cpu")
    unsharded = tstream.GraphStore.from_edges(V, s, t, w, device="cpu")
    return ref, port, unsharded


def _drive_twins(cfg, weighted, d, stores) -> dict:
    ref, port, uns = stores
    reg = None
    if not weighted:
        reg = tstream.PropertyRegistry(port)
        reg.register(tss.sharded_pagerank_property())
        reg.register(tss.sharded_bfs_property(0))
        reg.register(tss.sharded_wcc_property())
        reg.register(tss.sharded_triangle_property())
    log = [{"ref": _leaves_of_ref(ref), "port": M.store_leaves(port)}]
    for e, (kind, s, t, w, ds, dt) in enumerate(M.epochs(cfg, weighted)):
        bj = ref.apply(s, t, w, ds, dt)
        bt = port.apply(s, t, w, ds, dt)
        uns.apply(s, t, w, ds, dt)
        q = M.queries(cfg, e)
        row = {"kind": kind, "version": port.version,
               "ref_n": (bj.n_inserted, bj.n_deleted),
               "n": (bt.n_inserted, bt.n_deleted),
               "ins_mask": None if bt.ins_mask is None
               else bt.ins_mask.numpy(),
               "del_mask": None if bt.del_mask is None
               else bt.del_mask.numpy(),
               "ref_ins_mask": None if bj.ins_mask is None
               else np.asarray(bj.ins_mask),
               "ref_del_mask": None if bj.del_mask is None
               else np.asarray(bj.del_mask),
               "maintenance_count": port.maintenance_count,
               "ref": _leaves_of_ref(ref), "port": M.store_leaves(port),
               "query": uns.query(q[:, 0], q[:, 1]),
               "n_edges": uns.n_edges,
               "out_degree": port.out_degree.numpy()}
        if reg is not None and e in (0, 2):
            row["props"] = {name: reg.read(name).numpy() for name in PROPS}
        log.append(row)
    out = {"epochs": log, "ref": ref, "port": port,
           "recompile_count": port.recompile_count,
           "ref_recompile_count": ref.recompile_count,
           "meta": port._resilience_meta(),
           "events": [{k: v for k, v in ev.items() if k != "duration_s"}
                      for ev in port.maintenance_events],
           "pool_stats": port.pool_stats(chains=True)}
    if weighted:
        return out
    V = M.CONFIGS[cfg][0]
    tsg.reset_fix_stats()
    lab, it_w = tsg.wcc_sharded(port.symmetric,
                                rows=port.sweep_rows("symmetric"))
    dist_, it_b = tsg.bfs_sharded(port.transpose, src=0)
    pr, it_p = tsg.pagerank_sharded(port.transpose, port.out_degree,
                                    rows=port.sweep_rows("transpose"))
    j_lab, _ = jsg.wcc_sharded(ref.symmetric,
                               rows=ref.sweep_rows("symmetric"))
    j_dist, _ = jsg.bfs_sharded(ref.transpose, src=0)
    j_pr, _ = jsg.pagerank_sharded(ref.transpose, ref.out_degree,
                                   rows=ref.sweep_rows("transpose"))
    out["analytics"] = {"wcc": lab.numpy(), "bfs": dist_.numpy(),
                        "pagerank": pr.numpy(),
                        "iterations": (it_w, it_b, it_p),
                        "fix_stats": dict(tsg.FIX_STATS),
                        "ref_wcc": np_of(j_lab), "ref_bfs": np_of(j_dist),
                        "ref_pagerank": np_of(j_pr)}
    out["triangles"] = tsg.triangles_sharded(port.symmetric)
    out["in_degree"] = port.in_degree.numpy()
    nb = port.neighbors([0, 1, 2, 5, V - 1])
    out["neighbors"] = (nb.src.numpy(), nb.dst.numpy(), nb.weight.numpy(),
                        int(nb.size), bool(nb.overflow))
    resps = tstream.RequestPipeline(port, reg).run(
        M.pipeline_requests(tstream, cfg))
    out["pipeline"] = [(p.kind, p.version, M.payload_of(p)) for p in resps]
    port.maintain("compact")
    out["compact_pools"] = M.store_leaves(port)
    out["saved"] = port.save(d / "stacked_ckpt", registry=reg)
    return out


def _durability_twins(cfg, d) -> dict:
    """The stacked twins of the ranks' durability section: the scenario
    journaled and audited, its save; the reference's and the port's
    uninterrupted crash streams; audits of the planted pools."""
    from repro_torch import resilience as rz
    V, S, _ = M.CONFIGS[cfg]
    policy = tstream.MaintenancePolicy(tombstone_ratio=M.RATIO)
    store, _ = tstream.ShardedGraphStore.restore(d / "boot_u", device="cpu",
                                                 maintenance=policy)
    wal_dir = d / "stacked_wal"
    store.attach_wal(rz.WriteAheadLog(wal_dir, segment_records=1))
    store.attach_audits(rz.AuditPolicy(every=1))
    for kind, s, t, w, ds, dt in M.epochs(cfg):
        store.apply(s, t, w, ds, dt)
    out = {"audit_events": [{k: v for k, v in ev.items()
                             if k != "duration_s"}
                            for ev in store.audit_events],
           "wal": M.wal_files(wal_dir)}
    store.save(d / "stacked_wal_ckpt")
    out["wal_after_save"] = M.wal_files(wal_dir)
    store.wal.close()

    twin = {}
    for tag, mod, kw in (("ref", jstream, {}),
                         ("port", tstream, {"device": "cpu"})):
        st = M.crash_store(mod, S, **kw)
        versions = []
        for i_s, i_d, d_s, d_d in M.crash_stream():
            st.apply(i_s, i_d, None, d_s, d_d)
            versions.append(st.version)
        twin[tag] = (_leaves_of_ref(st) if tag == "ref"
                     else M.store_leaves(st))
        twin[tag + "_versions"] = versions
        if tag == "port":
            twin["meta"] = st._resilience_meta()
            twin["maintenance_count"] = st.maintenance_count
    out["crash_twin"] = twin

    audits = {}
    for kind in M.PLANTS:
        st, _ = tstream.ShardedGraphStore.restore(d / "boot_u", device="cpu")
        audits[kind] = M.report_of(rz.audit_store(st, **M.plant(kind, st)))
    out["audits"] = audits
    return out


@pytest.fixture(scope="module", params=M.CPU_CONFIGS)
def run(request, tmp_path_factory):
    """One configuration: the checkpoints the ranks restore, the ranks
    (started first), the twins driven meanwhile, the ranks' results."""
    cfg = request.param
    V, S, _ = M.CONFIGS[cfg]
    d = tmp_path_factory.mktemp(f"mesh_{cfg}")
    # the ranks restore the port's stacked stores as booted, and the
    # reference's unweighted one (its checkpoint)
    stores = {tag: _twin_store(cfg, tag == "w") for tag in ("u", "w")}
    for tag, (ref, port, _) in stores.items():
        port.save(d / f"boot_{tag}")
    stores["u"][0].save(d / "ref_ckpt")
    twins = {}
    t0 = time.perf_counter()
    group = RankGroup(M.mesh_rank, S, (cfg, str(d)), deadline_s=DEADLINE_S)
    try:
        for tag in ("u", "w"):
            twins[tag] = _drive_twins(cfg, tag == "w", d, stores.pop(tag))
        durability = _durability_twins(cfg, d)
    finally:
        try:
            group.wait()
        except RuntimeError as e:
            errors = [r.get("error") for r in M.load_results(str(d), S)
                      if r.get("error")] if all(
                os.path.exists(d / f"rank{r}.pkl") for r in range(S)) \
                else []
            raise RuntimeError(f"{e}\n" + "\n".join(errors)) from None
    ranks = M.load_results(str(d), S)
    return {"cfg": cfg, "V": V, "S": S, "dir": d, "ranks": ranks,
            "twins": twins, "durability": durability,
            "seconds": time.perf_counter() - t0}


# ============================================================================
# exchanges and routing
# ============================================================================

def test_collectives_equal_their_stacked_forms(run):
    V, S, ranks = run["V"], run["S"], run["ranks"]
    stacked = torch.arange(S * S * 3 * 2, dtype=torch.int32).reshape(
        S, S, 3, 2)
    want = C.exchange_buckets(stacked).numpy()
    n_local = -(-V // S)
    loc = torch.arange(S * n_local).reshape(S, n_local) * 3 - 7
    glob = C.gather_interleaved(loc, V).numpy()
    mask = C.or_across_shards(M.or_partials(S)).numpy()
    for r, res in enumerate(ranks):
        assert np.array_equal(res["exchange"], want[r]), r
        assert np.array_equal(res["gather"], glob), r
        assert np.array_equal(res["or"], mask), r
        assert res["max"].tolist() == [S - 1, 10]
        assert res["sum"].tolist() == [S * (S - 1) // 2,
                                       10 * S - S * (S - 1) // 2]
        nxt = (r + 1) % S
        assert res["ring"][0].tolist() == [nxt] * 3
        assert res["ring"][1].tolist() == [nxt, 10 - nxt]


def test_route_exchange_equals_the_stacked_routing(run):
    S, ranks = run["S"], run["ranks"]
    for name, s, d, w, cap in M.route_batches(run["cfg"]):
        n = len(s) // S
        blocks = []
        for i in range(S):
            blk = slice(i * n, (i + 1) * n)
            bs, bd, bw, orig, over = tsg.route_edges(
                ids(s)[blk], ids(d)[blk],
                None if w is None else torch.from_numpy(w)[blk],
                n_shards=S, cap=cap)
            orig = torch.where(orig >= 0, orig + i * n, -1)
            blocks.append((bs, bd, bw, orig, int(over)))
        witness = max(b[4] for b in blocks)
        for r, res in enumerate(ranks):
            got = res["route"][name]
            for j, col in enumerate(("bsrc", "bdst", "bw", "origin")):
                if blocks[0][j] is None:
                    assert got[j] is None, (name, col)
                    continue
                want = torch.cat([b[j][r] for b in blocks]).numpy()
                assert np.array_equal(got[j], want), (name, r, col)
            assert int(got[4]) == witness, (name, r)
        if name.endswith("small"):
            assert witness > 0, name          # the undersized cap overflows


def test_sharded_ops_equal_the_stacked_ops(run):
    """Insert, delete, query and ``apply_update_sharded`` on a mesh graph,
    at the always-safe cap and at cap 1 (which grows), then a growth of
    the pools: masks and pools equal the stacked ops' (which
    ``test_torch_sharded.py`` holds to the reference's)."""
    V, S, ranks = run["V"], run["S"], run["ranks"]
    s, d, dels, q, (ms, md, mdel) = M.op_batches(run["cfg"])
    for cap in (None, 1):
        g = tsg.shard_empty(V, S, capacity_slabs_per_shard=64, device="cpu")
        g, im = tsg.insert_edges_sharded(g, ids(s), ids(d), cap=cap)
        g, dm = tsg.delete_edges_sharded(g, ids(dels[:, 0]),
                                         ids(dels[:, 1]), cap=cap)
        qm = tsg.query_edges_sharded(g, ids(q[:, 0]), ids(q[:, 1]),
                                     cap=cap)
        g, ai, ad = tsg.apply_update_sharded(
            g, ids(ms), ids(md), None, ids(mdel[:, 0]), ids(mdel[:, 1]),
            cap=cap)
        pools = {"g": M.graph_leaves(g.graphs)}
        g = tsg.ensure_capacity_sharded(g, 200)
        want = {"ins": im, "del": dm, "query": qm, "apply_ins": ai,
                "apply_del": ad}
        for key, m in want.items():
            for r, res in enumerate(ranks):
                assert np.array_equal(res["ops"][cap][key], m.numpy()), \
                    (cap, key, r)
        for key, leaves in (("pools", pools),
                            ("grown", {"g": M.graph_leaves(g.graphs)})):
            got = _stack_ranks([{"g": r["ops"][cap][key]} for r in ranks])
            assert_leaves_equal(got, leaves, f"ops cap={cap} {key}")


# ============================================================================
# the store
# ============================================================================

@pytest.mark.parametrize("tag", ["u", "w"], ids=["unweighted", "weighted"])
def test_store_epochs_equal_leaf_for_leaf(run, tag):
    twin = run["twins"][tag]
    got = [r[f"store_{tag}"]["epochs"] for r in run["ranks"]]
    want = twin["epochs"]
    assert len(got[0]) == len(want)
    kinds = []
    for e, row in enumerate(want):
        pools = _stack_ranks([g[e]["pools"] for g in got])
        assert_leaves_equal(pools, row["port"], f"epoch {e} vs stacked")
        assert_leaves_equal(pools, row["ref"], f"epoch {e} vs reference")
        if e == 0:
            continue
        kinds.append(row["kind"])
        assert row["n"] == row["ref_n"], e
        for r, g in enumerate(got):
            assert (g[e]["n_inserted"], g[e]["n_deleted"]) == row["n"], \
                (e, r)
            assert g[e]["version"] == row["version"]
            assert g[e]["maintenance_count"] == row["maintenance_count"]
            for key in ("ins_mask", "del_mask"):
                if row[key] is None:
                    assert g[e][key] is None and row["ref_" + key] is None
                    continue
                assert np.array_equal(g[e][key], row[key]), (e, r, key)
                assert np.array_equal(g[e][key], row["ref_" + key]), (e, r)
    if tag == "u":
        caps = [row["port"]["forward"]["keys"].shape[1] for row in want]
        assert max(caps) > caps[0], "no epoch grew the pools"
        assert want[-1]["maintenance_count"] >= 1, \
            "the policy never compacted"
    assert set(kinds) == ({"mixed"} if tag == "w" else
                          {"skewed_grow", "delete_only", "insert_only"})


def test_queries_equal_the_unsharded_store(run):
    want = run["twins"]["u"]["epochs"]
    for r, res in enumerate(run["ranks"]):
        for e, row in enumerate(res["store_u"]["epochs"][1:], start=1):
            assert np.array_equal(row["query"], want[e]["query"]), (e, r)
            assert row["n_edges"] == want[e]["n_edges"], (e, r)
            assert np.array_equal(row["out_degree"], want[e]["out_degree"])


def test_host_accounting_equals_the_stacked_store(run):
    """Growth bounds, maintenance events and pool statistics as the stacked
    store's; the sticky total caps are the stacked store's under the mesh's
    mode, beside the pair caps of its all-to-all buckets; an epoch records
    one ``slab_update.update_shards`` dispatch a rank."""
    for tag in ("u", "w"):
        twin = run["twins"][tag]
        assert twin["recompile_count"] == twin["ref_recompile_count"]
        vmap_caps = {s: c for m, s, c in twin["meta"]["sticky_caps"]}
        for res in run["ranks"]:
            got = res[f"store_{tag}"]
            meta = got["meta"]
            assert meta["high_water"] == twin["meta"]["high_water"]
            for key in ("epochs_since_maint", "deletes_since_maint",
                        "tombstone_base", "last_reserve"):
                assert meta[key] == twin["meta"][key], key
            caps = {s: c for m, s, c in meta["sticky_caps"]}
            assert all(m == "shard_map" for m, _, _ in meta["sticky_caps"])
            assert {s: c for s, c in caps.items()
                    if not s.endswith("_pair")} == vmap_caps
            assert got["events"] == twin["events"]
            assert got["update_shards_calls"] == 1     # its first epoch
            assert got["pool_stats"] == twin["pool_stats"]
            assert got["recompile_count"] == \
                run["ranks"][0][f"store_{tag}"]["recompile_count"] >= 1


def test_analytics_equal(run):
    twin = run["twins"]["u"]
    want = twin["analytics"]
    iters = set()
    for r, res in enumerate(run["ranks"]):
        got = res["store_u"]["analytics"]
        assert np.array_equal(got["wcc"], want["wcc"])
        assert np.array_equal(got["wcc"], want["ref_wcc"])
        assert np.array_equal(got["bfs"], want["bfs"])
        assert np.array_equal(got["bfs"], want["ref_bfs"])
        assert got["pagerank"].dtype == np.float32
        assert np.array_equal(got["pagerank"], want["pagerank"])
        np.testing.assert_allclose(got["pagerank"], want["ref_pagerank"],
                                   atol=PR_ATOL, rtol=0)
        assert got["iterations"] == want["iterations"], r
        assert got["fix_stats"] == want["fix_stats"], r
        iters.add(got["iterations"])
        for e, row in enumerate(twin["epochs"]):
            if "props" not in row:
                continue
            props = res["store_u"]["epochs"][e]["props"]
            for name in PROPS:
                assert np.array_equal(props[name], row["props"][name]), \
                    (e, name)
    assert len(iters) == 1


def test_triangles_equal_the_stacked_count(run):
    """In int64, as the stacked count (``test_torch_sharded.py`` holds it
    to the reference's)."""
    want = run["twins"]["u"]["triangles"]
    for res in run["ranks"]:
        got = res["store_u"]["triangles"]
        assert got.dtype == torch.int64 and got.shape == ()
        assert int(got) == int(want) > 0


def test_pipeline_neighbors_and_degrees_equal_the_stacked_store(run):
    twin = run["twins"]["u"]
    for res in run["ranks"]:
        got = res["store_u"]
        assert np.array_equal(got["in_degree"], twin["in_degree"])
        for a, b in zip(got["neighbors"], twin["neighbors"]):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        assert len(got["pipeline"]) == len(twin["pipeline"])
        for (k1, v1, p1), (k2, v2, p2) in zip(got["pipeline"],
                                              twin["pipeline"]):
            assert (k1, v1) == (k2, v2)
            assert set(p1) == set(p2), k1
            for key in p2:
                a, b = p1[key], p2[key]
                if isinstance(b, tuple):
                    for x, y in zip(a, b):
                        assert np.array_equal(x, y), (k1, key)
                elif isinstance(b, np.ndarray):
                    assert np.array_equal(a, b), (k1, key)
                elif key != "latency_s":
                    assert a == b, (k1, key)


def _manifest(path) -> dict:
    from repro_torch.checkpoint.msgpack_codec import unpackb
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        return unpackb(f.read())


def test_mesh_checkpoint_equals_the_stacked_store_s(run):
    """After a forced compaction (which clears the sticky caps on both) the
    mesh store's save equals the stacked store's: every leaf file byte for
    byte, the manifest key for key but ``time`` (the save's wall clock)."""
    twin = run["twins"]["u"]
    pools = _stack_ranks([r["store_u"]["compact_pools"] for r in run["ranks"]])
    assert_leaves_equal(pools, twin["compact_pools"], "compacted")
    got, want = run["ranks"][0]["store_u"]["saved"], twin["saved"]
    assert all(r["store_u"]["saved"] == got for r in run["ranks"])
    assert os.path.basename(got) == os.path.basename(want)
    files = sorted(os.listdir(want))
    assert sorted(os.listdir(got)) == files
    for name in files:
        if name.startswith("manifest"):
            continue
        with open(os.path.join(got, name), "rb") as f1, \
                open(os.path.join(want, name), "rb") as f2:
            assert f1.read() == f2.read(), name
    m1, m2 = _manifest(got), _manifest(want)
    m1.pop("time"), m2.pop("time")
    assert m1 == m2
    back, _ = tstream.ShardedGraphStore.restore(
        os.path.dirname(got), device="cpu",
        specs=[tss.sharded_pagerank_property(), tss.sharded_bfs_property(0),
               tss.sharded_wcc_property(), tss.sharded_triangle_property()])
    assert_leaves_equal(M.store_leaves(back), twin["compact_pools"],
                        "restored")


def test_reference_checkpoint_restores_onto_the_mesh(run):
    """The reference's stacked store, saved as booted, restored on every
    rank and placed on the mesh, then its first epoch: the reference's
    pools before and after it."""
    want = run["twins"]["u"]["epochs"]
    got = [r["elastic"] for r in run["ranks"]]
    assert_leaves_equal(_stack_ranks([g["restored"] for g in got]),
                        want[0]["ref"], "restored")
    assert_leaves_equal(_stack_ranks([g["after"] for g in got]),
                        want[1]["ref"], "after one epoch")
    assert all(g["n"] == want[1]["ref_n"] for g in got)


def test_dispatch_errors_raise(run):
    V, S = run["V"], run["S"]
    for res in run["ranks"]:
        assert res["wrong_size"].startswith("ValueError"), res["wrong_size"]
        assert res["wrong_axis"].startswith("ValueError"), res["wrong_axis"]
        errors = res["store_u"]["errors"]
        assert errors["vmap"].startswith("ValueError")
        assert errors["other_shard"].startswith("ValueError")
        for name in ("audit", "attach_wal"):
            assert errors[name] == "", (name, errors[name])
        assert res["store_u"]["audit"]["ok"]
    g = tsg.shard_empty(V, S, capacity_slabs_per_shard=64, device="cpu")
    with pytest.raises(ValueError, match="place_on_mesh"):
        tsg.wcc_sharded(g, dispatch="shard_map")
    store = tstream.ShardedGraphStore({"forward": g}, weighted=False,
                                      dispatch="shard_map")
    with pytest.raises(ValueError, match="place_on_mesh"):
        store.apply([1], [2])
    with pytest.raises(ValueError, match="unknown dispatch"):
        tsg.bfs_sharded(g, src=0, dispatch="pmap")


# ============================================================================
# durability: the WAL, recovery and audits on the mesh
# ============================================================================

def test_mesh_wal_and_audits_equal_the_stacked_store_s(run):
    """Rank 0 journals each epoch once (one segment a record): the WAL
    equals the stacked store's byte for byte, and after a save at the
    current version both keep the same last segment; every epoch's audit
    is clean and equal to the stacked store's."""
    want = run["durability"]
    n = len(M.epochs(run["cfg"]))
    assert len(want["wal"]) == n and want["audit_events"]
    assert len(want["wal_after_save"]) == 1
    for r, res in enumerate(run["ranks"]):
        got = res["durability"]
        assert got["wal"] == want["wal"], r
        assert got["wal_after_save"] == want["wal_after_save"], r
        assert got["appended"] == (n if r == 0 else 0), r
        assert got["audit_events"] == want["audit_events"], r
        assert all(ev["ok"] for ev in got["audit_events"])


@pytest.mark.parametrize("site", M.APPLY_SITES)
def test_mesh_recovers_at_each_apply_site(run, site):
    """A kill at ``site`` in batch CRASH_AT on every rank, a checkpoint
    saved before batch CKPT_AT; ``recover`` (the stacked store, WAL
    replayed) and ``place_on_mesh`` with the WAL re-attached, then the rest
    of the stream: every rank's pools equal the uninterrupted twins'."""
    twin = run["durability"]["crash_twin"]
    vers = twin["port_versions"]
    assert vers == twin["ref_versions"]
    ranks = [r["durability"][site] for r in run["ranks"]]
    for r, got in enumerate(ranks):
        assert got["crashed"].startswith("injected crash at"), (r, got)
        assert not got["anomalies"]
        assert got["checkpoint_version"] == vers[M.CKPT_AT - 1]
        assert got["resume"] == (M.CRASH_AT if site in M.APPLY_SITES[:2]
                                 else M.CRASH_AT + 1)
        assert got["version"] == vers[-1]
        assert got["maintenance_count"] == twin["maintenance_count"]
        for key, value in twin["meta"].items():
            if key != "sticky_caps":
                assert got["meta"][key] == value, key
        assert got["pagerank_finite"]
        assert got["wal_appended"] == (
            (M.N_BATCHES - got["resume"]) if r == 0 else 0)
    pools = _stack_ranks([g["pools"] for g in ranks])
    assert_leaves_equal(pools, twin["port"], f"{site} vs stacked twin")
    assert_leaves_equal(pools, twin["ref"], f"{site} vs reference twin")
    reasons = {g["crash_reason"] for g in ranks}
    assert f"injected_crash@{site}" in reasons
    assert reasons <= {f"injected_crash@{site}", None}


@pytest.mark.parametrize("kind", M.PLANTS)
def test_mesh_audit_equals_the_stacked_audit(run, kind):
    """Clean pools, and a degree, a chain cycle or a stray key planted in
    one rank's shard: the report on every rank equals the stacked store's
    (violations word for word, checks run)."""
    want = run["durability"]["audits"][kind]
    assert want["ok"] == (kind == "clean")
    for r, res in enumerate(run["ranks"]):
        assert res["durability"]["audits"][kind] == want, r


def test_a_failure_on_one_rank_raises_on_every_rank(run):
    """Rank 1 alone fails: an allocation failure before the close raises on
    every rank and rolls rank 0's WAL record back; a kill after it raises
    on every rank (``MeshPeerFailure`` on the others) and keeps it."""
    for r, res in enumerate(run["ranks"]):
        got = res["durability"]["one_rank"]
        assert got["oom"] == "InjectedOOM", r
        assert got["kill"] == ("InjectedCrash" if r == 1
                               else "MeshPeerFailure"), r
        assert got["oom_appended"] == (1 if r == 0 else 0)
        assert got["kill_appended"] == (2 if r == 0 else 0)


def test_ranks_import_no_jax_and_finish_in_time(run):
    assert not any(r["jax_imported"] for r in run["ranks"])
    assert all("error" not in r for r in run["ranks"])
    assert run["seconds"] < DEADLINE_S


def test_a_diverging_rank_fails_within_the_deadline(tmp_path):
    """Rank 0 waits in an all-reduce that rank 1 never joins: the parent's
    deadline kills the group and raises."""
    t0 = time.perf_counter()
    group = RankGroup(M.diverging_rank, 2, (str(tmp_path),), deadline_s=8)
    with pytest.raises(RuntimeError, match="deadline|failed"):
        group.wait()
    assert time.perf_counter() - t0 < 40
    assert all(not p.is_alive() for p in group.procs)
