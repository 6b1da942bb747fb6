"""The packed-row invariant of the slab pools, on the CPU, in both packages.

The port's sweep and intersection-count kernels read a slab row only up to
its first EMPTY lane.  That is exact because every engine path keeps each
row packed: its keys form a prefix (live and TOMBSTONE lanes first, every
lane after the first EMPTY lane EMPTY), only a chain's tail row holds an
EMPTY lane, ``tail_fill`` counts the filled lanes of each bucket's tail, and
an unallocated row is all EMPTY.  These tests check every row of the pools
after each path of the port (build, insert with overflow into fresh and
recycled slabs, delete, epoch close, reclamation, compaction, the triangle
plane's batch graph and symmetric view), and of the pools the JAX reference
builds on the same paths, carried across with ``to_port``.

The chain-walk probe and the chain-rank walk read a hub's chain a run of
consecutive rows at a time, which is fast because bulk builds and
compaction lay every bucket's overflow slabs out consecutively.  The link
tests below check that layout: after a build or a compaction every link out
of an overflow slab is ``r -> r + 1``; the update engine's appended slabs
and a reclamation's splices over freed rows are the only other links that
are not.  The kernels' results do not rest on it (they follow only links
they have read), so ``permuted_rows`` relabels a pool's overflow rows to
test them where almost no link is consecutive.

The commit kernel sums the degree deltas of each run of one ``deg_idx``
before a single atomic add, which is fast because the engine hands it plans
sorted by bucket: ``test_commit_plans_hold_degree_runs`` checks that every
live ``deg_idx`` of every plan the engine commits is one run, parked
entries aside.  Its result does not rest on it (a run split anywhere adds
each part), only its speed.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import ids, to_port

from repro import stream as jstream
from repro.algorithms import triangle as jtri
from repro.core import delete_edges as j_delete
from repro.core import ensure_capacity as j_ensure
from repro.core import from_edges_host as j_build
from repro.core import insert_edges as j_insert
from repro.core import update_slab_pointers as j_close
from repro.kernels.slab_compact import compact as j_compact
from repro.kernels.slab_compact import reclaim_free_slabs as j_reclaim
from repro_torch import stream as tstream
from repro_torch.algorithms import triangle as ttri
from repro_torch.core import batch as tbatch
from repro_torch.core.slab_graph import (ensure_capacity, from_edges_host,
                                         update_slab_pointers)
from repro_torch.kernels.slab_compact import compact, reclaim_free_slabs
from repro_torch.kernels.slab_update import ops as update_ops

EMPTY = -2          # EMPTY_KEY as the port's int32 bit pattern
V = 60


def assert_packed(g, what: str) -> None:
    """Every row of ``g`` (a port SlabGraph) is packed; see the module
    docstring for the four parts."""
    keys = g.keys.cpu().numpy()
    nxt = g.next_slab.cpu().numpy()
    alloc = g.slab_vertex.cpu().numpy() >= 0
    empty = keys == EMPTY
    after = np.logical_or.accumulate(empty, axis=1) & ~empty
    bad = np.nonzero(after.any(axis=1))[0]
    assert not bad.size, (f"{what}: {bad.size} rows hold a key after an "
                          f"EMPTY lane, first row {bad[:1]}")
    open_rows = np.nonzero(alloc & empty.any(axis=1))[0]
    assert (nxt[open_rows] == -1).all(), \
        f"{what}: a row with an EMPTY lane is not its chain's tail"
    filled = (~empty).sum(axis=1)
    tail = g.tail_slab.cpu().numpy()
    assert np.array_equal(filled[tail], g.tail_fill.cpu().numpy()), \
        f"{what}: tail_fill is not the tail rows' fill"
    assert empty[~alloc].all(), f"{what}: an unallocated row holds a key"


def permuted_rows(keys, next_slab, slab_vertex, n_buckets: int, seed: int):
    """The same chains with the overflow rows (``n_buckets`` up) relabelled
    by a seeded permutation: ``(keys, next_slab, slab_vertex)`` as numpy."""
    S = len(next_slab)
    perm = np.arange(S)
    perm[n_buckets:] = n_buckets + np.random.default_rng(seed).permutation(
        S - n_buckets)
    k, sv = np.empty_like(keys), np.empty_like(slab_vertex)
    k[perm], sv[perm] = keys, slab_vertex
    nx = np.full_like(next_slab, -1)
    nx[perm] = np.where(next_slab >= 0, perm[np.maximum(next_slab, 0)], -1)
    return k, nx, sv


def link_faults(g, *, appended=None, freed=None) -> list:
    """The links ``r -> n`` of a port graph that are none of: ``r + 1``, a
    head's link to its first overflow slab, a link into a row in
    ``appended`` (rows the update engine allocated), or a splice over rows
    that are all in ``freed`` (rows a reclamation unlinked)."""
    nxt = g.next_slab.cpu().numpy().astype(np.int64)
    S, nb = len(nxt), g.n_buckets
    appended = np.zeros(S, bool) if appended is None else appended
    freed = np.zeros(S, bool) if freed is None else freed
    r = np.nonzero(nxt >= 0)[0]
    n = nxt[r]
    ok = (n == r + 1) | ((r < nb) & (n >= nb)) | appended[n]
    bad = []
    for a, b in zip(r[~ok], n[~ok]):
        if not (b > a + 1 and freed[a + 1:b].all()):
            bad.append((int(a), int(b)))
    return bad


def _allocated(g) -> np.ndarray:
    return g.slab_vertex.cpu().numpy() >= 0


def _edges(rng):
    """Random edges plus three hubs whose chains overflow."""
    src = rng.integers(0, V, 1500)
    dst = rng.integers(0, 4 * V, 1500)
    src[:900] = np.repeat([3, 7, 11], 300)
    dst[:900] = rng.integers(0, 100000, 900)
    return src.astype(np.uint32), dst.astype(np.uint32)


def _hub_edges(rng, hubs, n):
    s = np.repeat(np.asarray(hubs, np.uint32), n // len(hubs))
    d = rng.integers(200000, 300000, len(s)).astype(np.uint32)
    return s, d


def _live_of(g, hubs):
    """The live (src, dst) lanes of ``hubs`` in a port graph."""
    keys = g.keys.cpu().numpy()
    owner = g.slab_vertex.cpu().numpy()
    live = (keys >= 0) & np.isin(owner, hubs)[:, None]
    rows, lanes = np.nonzero(live)
    return owner[rows].astype(np.uint32), keys[rows, lanes].astype(np.uint32)


@pytest.mark.parametrize("hashing", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_port_paths_keep_rows_packed(seed, hashing):
    rng = np.random.default_rng(seed)
    src, dst = _edges(rng)
    g = from_edges_host(V, src, dst, hashing=hashing, device="cpu")
    assert_packed(g, "build")
    # inserts that overflow the hubs' tails into fresh slabs
    s, d = _hub_edges(rng, [3, 20, 41], 900)
    g = ensure_capacity(g, len(s) // 16 + 64)
    nf = int(g.next_free)
    g, m = tbatch.insert_edges(g, ids(s), ids(d))
    assert int(m.sum()) > 0 and int(g.next_free) > nf
    assert_packed(g, "insert")
    g, m = tbatch.delete_edges(g, ids(src[::3]), ids(dst[::3]))
    assert int(m.sum()) > 0
    assert_packed(g, "delete")
    g = update_slab_pointers(g)
    assert_packed(g, "epoch close")
    # every edge of two hubs deleted: wholly dead overflow slabs, reclaimed
    hs, hd = _live_of(g, [3, 20])
    g, _ = tbatch.delete_edges(g, ids(hs), ids(hd))
    g = update_slab_pointers(g)
    g, n_freed = reclaim_free_slabs(g)
    assert n_freed > 0
    assert_packed(g, "reclaim")
    # inserts after the reclamation open recycled slabs
    s, d = _hub_edges(rng, [5, 41], 600)
    top = int(g.free_top)
    g, _ = tbatch.insert_edges(g, ids(s), ids(d))
    assert int(g.free_top) < top
    assert_packed(g, "insert into recycled slabs")
    g, _ = compact(g)
    assert_packed(g, "compact")
    s, d = _hub_edges(rng, [7, 8], 400)
    g = ensure_capacity(g, 64)
    g, _ = tbatch.insert_edges(g, ids(s), ids(d))
    assert_packed(g, "insert after compaction")


@pytest.mark.parametrize("hashing", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_reference_paths_keep_rows_packed(seed, hashing):
    rng = np.random.default_rng(seed)
    src, dst = _edges(rng)
    g = j_build(V, src, dst, hashing=hashing)
    assert_packed(to_port(g), "build")
    s, d = _hub_edges(rng, [3, 20, 41], 900)
    g = j_ensure(g, len(s) // 16 + 64)
    g, _ = j_insert(g, jnp.asarray(s), jnp.asarray(d))
    assert_packed(to_port(g), "insert")
    g, _ = j_delete(g, jnp.asarray(src[::3]), jnp.asarray(dst[::3]))
    assert_packed(to_port(g), "delete")
    g = j_close(g)
    assert_packed(to_port(g), "epoch close")
    hs, hd = _live_of(to_port(g), [3, 20])
    g, _ = j_delete(g, jnp.asarray(hs), jnp.asarray(hd))
    g, n_freed = j_reclaim(j_close(g))
    assert n_freed > 0
    assert_packed(to_port(g), "reclaim")
    s, d = _hub_edges(rng, [5, 41], 600)
    top = int(g.free_top)
    g, _ = j_insert(g, jnp.asarray(s), jnp.asarray(d))
    assert int(g.free_top) < top
    assert_packed(to_port(g), "insert into recycled slabs")
    g, _ = j_compact(g)
    assert_packed(to_port(g), "compact")


@pytest.mark.parametrize("hashing", [False, True])
@pytest.mark.parametrize("package", ["port", "reference"])
def test_overflow_links_are_consecutive(package, hashing):
    """After a build and after a compaction every overflow link is
    ``r -> r + 1``; in between, inserts that overflow into fresh and
    recycled slabs and a reclamation add only the links ``link_faults``
    allows.  Unhashed, the hubs' chains hold consecutive runs."""
    rng = np.random.default_rng(3)
    src, dst = _edges(rng)
    hub = np.full(300, 3, np.uint32)       # hub 3's chain: five rows
    src = np.concatenate([src, hub])
    dst = np.concatenate([dst, rng.integers(100000, 200000, 300)
                          .astype(np.uint32)])
    port = package == "port"
    as_port = (lambda g: g) if port else to_port

    def insert(g, s, d):
        if port:
            return tbatch.insert_edges(g, ids(s), ids(d))[0]
        return j_insert(g, jnp.asarray(s), jnp.asarray(d))[0]

    def delete(g, s, d):
        if port:
            return update_slab_pointers(
                tbatch.delete_edges(g, ids(s), ids(d))[0])
        return j_close(j_delete(g, jnp.asarray(s), jnp.asarray(d))[0])

    g = (from_edges_host(V, src, dst, hashing=hashing, device="cpu")
         if port else j_build(V, src, dst, hashing=hashing))
    gp = as_port(g)
    assert link_faults(gp) == [], "build"
    if not hashing:          # hashed buckets are sized to fit at build
        assert (gp.next_slab.numpy()[gp.n_buckets:] >= 0).any()

    s, d = _hub_edges(rng, [3, 20, 41], 900)
    g = ensure_capacity(g, len(s) // 16 + 64) if port else \
        j_ensure(g, len(s) // 16 + 64)
    before = _allocated(as_port(g))
    g = insert(g, s, d)
    gp = as_port(g)
    fresh = _allocated(gp) & ~before
    assert fresh.any()
    assert link_faults(gp, appended=fresh) == [], "insert"

    # hub 20's edges all deleted, and those of the second overflow slab of
    # each of hub 3's chains, then the dead slabs reclaimed: hub 3's chains
    # are spliced over the freed rows
    keys = gp.keys.numpy()
    nxt = gp.next_slab.numpy()
    off, cnt = gp.bucket_offset.numpy(), gp.bucket_count.numpy()
    dead_rows = []
    for b in range(off[3], off[3] + cnt[3]):
        rows = [b]
        while nxt[rows[-1]] >= 0:
            rows.append(int(nxt[rows[-1]]))
        dead_rows += rows[2:3] if len(rows) > 3 else []
    hd = keys[dead_rows][keys[dead_rows] >= 0].astype(np.uint32)
    s20, d20 = _live_of(gp, [20])
    g = delete(g, np.concatenate([np.full(len(hd), 3, np.uint32), s20]),
               np.concatenate([hd, d20]))
    before = _allocated(as_port(g))
    g, n_freed = reclaim_free_slabs(g) if port else j_reclaim(g)
    assert n_freed > 0
    gp = as_port(g)
    freed = before & ~_allocated(gp)
    assert link_faults(gp, appended=fresh, freed=freed) == [], "reclaim"
    if not hashing:
        assert len(link_faults(gp, appended=fresh)) > 0   # a splice

    s, d = _hub_edges(rng, [5, 41], 600)
    before = _allocated(gp)
    g = insert(g, s, d)
    gp = as_port(g)
    fresh |= _allocated(gp) & ~before
    assert link_faults(gp, appended=fresh, freed=freed) == [], \
        "insert into recycled slabs"

    g = compact(g)[0] if port else j_compact(g)[0]
    gp = as_port(g)
    assert link_faults(gp) == [], "compact"
    if not hashing:
        assert (gp.next_slab.numpy()[gp.n_buckets:] >= 0).any()


def degree_runs(deg_idx, n_vertices: int):
    """``(runs, distinct)`` of a commit plan's live ``deg_idx`` (inside
    ``[0, n_vertices)``), parked entries dropped: equal when each live
    vertex is one run."""
    d = deg_idx.cpu().numpy()
    live = d[(d >= 0) & (d < n_vertices)]
    runs = int(live.size > 0) + int((live[1:] != live[:-1]).sum())
    return runs, int(np.unique(live).size)


@pytest.mark.parametrize("hashing", [False, True])
def test_commit_plans_hold_degree_runs(hashing, monkeypatch):
    """Every plan the update engine commits, on a forward, a transpose and
    a symmetric view of a graph with an out-hub and an in-hub, holds each
    live ``deg_idx`` in one run, parked entries aside: the delete and the
    insert plans of each view, hashed and not."""
    plans = []
    real = update_ops.slab_commit

    def commit(keys, degree, weights, e_slab, e_lane, vals, deg_idx, *rest):
        plans.append((deg_idx.clone(), degree.shape[0]))
        return real(keys, degree, weights, e_slab, e_lane, vals, deg_idx,
                    *rest)

    monkeypatch.setattr(update_ops, "slab_commit", commit)
    rng = np.random.default_rng(6)
    n = 2000
    src = rng.integers(0, n, 6000).astype(np.uint32)
    dst = rng.integers(0, n, 6000).astype(np.uint32)
    src[:1500], dst[1500:3000] = 3, 7          # out-hub 3, in-hub 7
    src, dst = np.unique(np.stack([src, dst], 1), axis=0).T
    views = tuple(from_edges_host(n, s, d, hashing=hashing, device="cpu")
                  for s, d in ((src, dst), (dst, src),
                               (np.concatenate([src, dst]),
                                np.concatenate([dst, src]))))
    views = tuple(ensure_capacity(g, 256) for g in views)
    roles = (update_ops.FORWARD, update_ops.TRANSPOSE, update_ops.SYMMETRIC)
    gone = rng.permutation(len(src))[:1200]    # deletes, hub edges among them
    s_new = rng.integers(0, n, 3000).astype(np.uint32)
    d_new = rng.integers(0, n, 3000).astype(np.uint32)
    s_new[:800], d_new[800:1600] = 3, 7
    update_ops.update_views(views, roles,
                            ins=(ids(s_new), ids(d_new), None),
                            dels=(ids(src[gone]), ids(dst[gone])))
    # the forward view's delete, the transpose's, the symmetric's; then
    # the three inserts
    assert len(plans) == 6
    longest = 0
    for i, (deg_idx, V) in enumerate(plans):
        runs, distinct = degree_runs(deg_idx, V)
        assert distinct > 0 and runs == distinct, \
            f"plan {i}: {distinct} live vertices in {runs} runs"
        d = deg_idx.numpy()
        live = (d >= 0) & (d < V)
        longest = max(longest, int(np.bincount(d[live]).max()))
    assert longest >= 300                       # a hub's run, not only 1s


def test_degree_runs_counts_split_runs():
    """The run count sees a vertex that comes back after another one, and
    lets a parked entry sit inside a run."""
    V = 10
    assert degree_runs(torch.tensor([2, 2, V, 2, 5, -1, 5]), V) == (2, 2)
    assert degree_runs(torch.tensor([2, 5, 2]), V) == (3, 2)
    assert degree_runs(torch.tensor([V, -1]), V) == (0, 0)


def test_link_faults_and_permuted_rows():
    """The link check fails a relabelled pool, which keeps every chain."""
    rng = np.random.default_rng(4)
    src, dst = _edges(rng)
    g = from_edges_host(V, src, dst, hashing=False, device="cpu")
    fields = (g.keys.numpy(), g.next_slab.numpy(), g.slab_vertex.numpy())
    k, nx, sv = permuted_rows(*fields, g.n_buckets, seed=0)
    faults = link_faults(dataclasses.replace(
        g, next_slab=torch.from_numpy(nx)))
    assert len(faults) > 0.9 * int((fields[1][g.n_buckets:] >= 0).sum())

    def chains(keys, nxt):
        out = []
        for b in range(g.n_buckets):
            rows, r = [], b
            while r >= 0:
                rows.append(keys[r].tolist())
                r = nxt[r]
            out.append(rows)
        return out

    assert chains(k, nx) == chains(fields[0], fields[1])
    assert (sv[nx[nx >= 0]] == sv[nx >= 0]).all()


def _loop_free(rng, n):
    lo, hi = ttri.undirected_host(rng.integers(0, V, n).astype(np.uint32),
                                  rng.integers(0, V, n).astype(np.uint32))
    keep = lo != hi
    return lo[keep], hi[keep]


@pytest.mark.parametrize("seed", [0, 1])
def test_triangle_plane_keeps_rows_packed(seed):
    """The batch graph of both packages, and the stores' symmetric views
    through insert-only, delete-only and mixed epochs with maintenance."""
    rng = np.random.default_rng(seed)
    lo, hi = _loop_free(rng, 400)
    bl, bh = _loop_free(rng, 200)
    mask = rng.random(len(bl)) < 0.9
    gb = ttri.batch_graph(V, ids(bl), ids(bh), torch.from_numpy(mask))
    assert_packed(gb, "port batch graph")
    assert_packed(to_port(jtri.batch_graph(V, jnp.asarray(bl),
                                           jnp.asarray(bh),
                                           jnp.asarray(mask))),
                  "reference batch graph")
    policy = dict(tombstone_ratio=0.05, every=3)
    ts = tstream.GraphStore.from_edges(
        V, lo, hi, hashing=True, device="cpu",
        maintenance=tstream.MaintenancePolicy(**policy))
    js = jstream.GraphStore.from_edges(
        V, lo, hi, hashing=True,
        maintenance=jstream.MaintenancePolicy(**policy))
    for ep in range(6):
        il, ih = _loop_free(rng, 80)
        pick = rng.choice(len(lo), 40, replace=False)
        kw = [dict(ins_src=il, ins_dst=ih),
              dict(del_src=lo[pick], del_dst=hi[pick]),
              dict(ins_src=il, ins_dst=ih, del_src=lo[pick],
                   del_dst=hi[pick])][ep % 3]
        ts.apply(**kw)
        js.apply(**kw)
        assert_packed(ts.symmetric, f"port symmetric view, epoch {ep}")
        assert_packed(to_port(js.symmetric),
                      f"reference symmetric view, epoch {ep}")
    assert ts.maintenance_count > 0


@pytest.mark.parametrize("fault", ["key after EMPTY", "EMPTY mid-chain",
                                   "tail_fill", "unallocated key"])
def test_assert_packed_catches_each_fault(fault):
    """The check itself: each of its four parts fails on a planted fault."""
    rng = np.random.default_rng(2)
    src, dst = _edges(rng)
    g = from_edges_host(V, src, dst, hashing=False, device="cpu")
    assert_packed(g, "clean")
    chained = int(torch.nonzero(g.next_slab >= 0)[0])
    tail = int(g.tail_slab[3])
    if fault == "key after EMPTY":
        g.keys[tail, 127] = 5
    elif fault == "EMPTY mid-chain":
        g.keys[chained, 127] = EMPTY
        g.tail_fill[:] = (g.keys[g.tail_slab.long()] != EMPTY).sum(1)
    elif fault == "tail_fill":
        g.tail_fill[3] += 1
    else:
        g.keys[int(torch.nonzero(g.slab_vertex < 0)[0]), 0] = 5
    with pytest.raises(AssertionError):
        assert_packed(g, fault)
