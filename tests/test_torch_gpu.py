"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Run on a machine with a CUDA card: ``python -m pytest -q -m gpu``.  Without
one every test here skips (the decision is made in the fixture, not at
import).  The sweep and the intersection count read a row only up to its
first EMPTY lane, so they are also held on packed rows filled to each side
of every 32-lane step.  Probe, commit, census, chain walk, the intersection
count, the membership probe and the min family must match exactly; the float
``sum`` sweep adds lanes in another order, so it is held to
``rtol=1e-6`` of the row totals.  Flash attention and EmbeddingBag are
held to the reference tests' tolerances (attention 2e-5 in float32, 2e-2
in bfloat16; the bag 1e-5 and 3e-2).  The sharded store on the card is
held to the same store on CPU tensors leaf for leaf, its WCC, BFS and
triangle count bit for bit and its PageRank within 2e-5; so are the
multi-process rendering's ranks on the card (two gloo ranks sharing it,
one NCCL rank), against the stacked store on the card, and one NCCL
rank's WAL, audits and recovery onto the card.  The MoE FFN and MIND on
the card are held to the same functions on CPU tensors (float32 without
TF32: 1e-4; histories bit for bit).  Kernel 10's backward is held to
``attention_bwd_ref`` (1e-4 in float32, 2e-2 in bfloat16: one rounding of
either output) and to itself bit for bit, and a train step on the card to
the same step on the CPU, as is each GNN smoke config's step (1e-5 /
1e-4).  Kernel 4 is held to its plain version on the card (1e-6 of the
row totals) on a packed pool and on one whose keys follow EMPTY lanes,
where kernel 3 reads less.  This module
imports no JAX (the card's machine has none): ``ATTN_CASES`` is shared with
the CPU parity test.
"""
import numpy as np
import pytest
import torch

from repro_torch.algorithms import (bfs_vanilla, wcc_incremental_batch,
                                    wcc_incremental_naive,
                                    wcc_incremental_slab_iterator,
                                    wcc_incremental_update_iterator,
                                    wcc_static)
from repro_torch.core import batch as tbatch
from repro_torch.core import (csr_snapshot, ensure_capacity,
                              occupancy_stats, slab_iterator,
                              transpose_host, update_iterator,
                              updated_lane_mask, updated_vertices)
from repro_torch.core.union_find import init_parents
from repro_torch.core.worklist import updated_edges
from repro_torch.core.bridge import slab_graph_from_numpy, \
    slab_graph_to_numpy
from repro_torch.core.slab_graph import FIELDS, from_edges_host
from repro_torch.kernels import runtime
from repro_torch.algorithms import triangle as ttri
from repro_torch.kernels.slab_compact import (chain_rank, chain_rank_torch,
                                              compact, slab_live,
                                              slab_live_torch)
from repro_torch.kernels.slab_sweep import SEMIRINGS, slab_sweep, \
    slab_sweep_ref
from repro_torch.kernels.slab_intersect import (count_edges,
                                                materialize_chains,
                                                probe_hits, probe_hits_torch,
                                                slab_count, slab_count_torch)
from repro_torch.kernels.slab_intersect.ops import _work_items
from repro_torch.kernels.slab_update import (insert_edges_ref, slab_commit,
                                             slab_commit_torch, slab_probe,
                                             slab_probe_torch)
from repro_torch.kernels.embedding_bag import embedding_bag, \
    embedding_bag_ref
from repro_torch.kernels.embedding_bag import kernel as bag_kernel
from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                 attention_lse_ref,
                                                 attention_ref,
                                                 flash_attention)
from repro_torch.kernels.flash_attention import kernel as attn_kernel
from repro_torch.models.transformer import (LMConfig, TransformerLM,
                                            init_cache, init_params)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def graph(cuda):
    rng = np.random.default_rng(0)
    V, E = 5000, 60000
    src = rng.integers(0, V, E)
    dst = rng.zipf(1.6, E) % V
    src[:600] = 7                                   # a hub: long chain
    return rng, src, dst, from_edges_host(V, src, dst, hashing=False,
                                          device=cuda)


def _ids(a, dev):
    return torch.from_numpy(np.asarray(a, np.int64).astype(np.uint32)
                            .view(np.int32)).to(dev)


def test_probe_matches_plain(cuda, graph):
    rng, src, dst, g = graph
    B = 3000
    start = _ids(src[:B], cuda)
    start[::9] = -1
    d = _ids(np.where(rng.random(B) < 0.5, dst[:B],
                      rng.integers(0, g.n_vertices, B)), cuda)
    before = runtime.LAUNCHES["slab_probe"]
    got = slab_probe(g.keys, g.next_slab, start, d)
    want = slab_probe_torch(g.keys, g.next_slab, start, d)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["slab_probe"] == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


#: run lengths of one deg_idx in a sorted commit plan: one entry, a warp's
#: 32 threads less, at and past one, and one that crosses many warps and
#: blocks; 5,303 entries, not a multiple of 4.  The wide plan adds a run of
#: 300,000, past the threads the card holds at once, so its blocks do not
#: all run together
COMMIT_RUNS = (1, 31, 32, 33, 5000, 2, 7, 64, 1, 129, 3)
COMMIT_PLANS = ["random", "sorted runs", "sorted runs, unaligned",
                "wide sorted runs", "wide sorted runs, unaligned"]


def _commit_plan(S, V, B, dev):
    """Distinct (slab, lane) targets, a quarter of them and any past the
    pool's S * 128 slots parked at S, and their values."""
    slots = torch.randperm(S * 128, device=dev)[:B]
    e_slab = torch.full((B,), S, dtype=torch.int32, device=dev)
    e_lane = torch.zeros(B, dtype=torch.int32, device=dev)
    e_slab[:slots.numel()] = (slots // 128).to(torch.int32)
    e_lane[:slots.numel()] = (slots % 128).to(torch.int32)
    e_slab[::4] = S
    vals = torch.randint(0, V, (B,), dtype=torch.int32, device=dev)
    return e_slab, e_lane, vals


def _sorted_runs(rng, V, runs):
    """``(deg_idx, delta)`` in ``runs`` over sorted distinct vertices, with
    parked entries (V and above, or -1) inside runs and mixed +1 / -1
    deltas."""
    verts = np.sort(rng.choice(V, len(runs), replace=False))
    idx = np.repeat(verts, runs).astype(np.int32)
    parked = rng.random(idx.size) < 0.05
    idx[parked] = rng.choice([V, V + 3, -1], int(parked.sum()))
    delta = rng.choice([-1, 1], idx.size).astype(np.int32)
    return idx, delta


@pytest.mark.parametrize("plan", COMMIT_PLANS)
@pytest.mark.parametrize("weighted", [False, True])
def test_commit_matches_plain(cuda, graph, weighted, plan):
    """The commit equals its plain version bit for bit: on a random plan,
    and on plans sorted into runs of one ``deg_idx`` whose deltas the
    kernel sums over a warp before one atomic (runs across warp and block
    edges, parked entries inside them), one past the threads the card
    holds at once, with the plan arrays 16-byte aligned or not."""
    rng, _, _, g = graph
    S, V = g.capacity_slabs, g.n_vertices
    if plan == "random":
        B = 4096
        idx = torch.randint(0, V + 16, (B,), dtype=torch.int32, device=cuda)
        delta = torch.randint(-1, 2, (B,), dtype=torch.int32, device=cuda)
    else:
        runs = COMMIT_RUNS + ((300000,) if plan.startswith("wide") else ())
        idx, delta = (torch.from_numpy(a).to(cuda)
                      for a in _sorted_runs(rng, V, runs))
        B = idx.numel()
        assert B % 4 != 0
    e_slab, e_lane, vals = _commit_plan(S, V, B, cuda)
    wv = torch.rand(B, device=cuda) if weighted else None
    arrays = [e_slab, e_lane, vals, idx, delta, wv]
    if plan.endswith("unaligned"):            # 4 bytes past a 16-byte edge
        arrays = [None if a is None else
                  torch.cat([a[:1], a])[1:] for a in arrays]
        assert all(a.data_ptr() % 16 == 4 for a in arrays if a is not None)
    w = torch.rand(S, 128, device=cuda) if weighted else None
    outs = []
    before = runtime.LAUNCHES["slab_commit"]
    for fn in (slab_commit, slab_commit_torch):
        keys, deg = g.keys.clone(), g.degree.clone()
        ww = None if w is None else w.clone()
        fn(keys, deg, ww, *arrays)
        outs.append((keys, deg, ww))
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["slab_commit"] == before + 1
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert not torch.equal(outs[0][1], g.degree)
    if weighted:
        assert torch.equal(outs[0][2], outs[1][2])


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("frontier", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_sweep_matches_plain(cuda, graph, semiring, frontier, weighted):
    rng, _, _, g = graph
    V, S = g.n_vertices, g.capacity_slabs
    values = torch.rand(V, device=cuda) * 5
    f = (torch.rand(V, device=cuda) < 0.3) if frontier else None
    w = torch.rand(S, 128, device=cuda) + 0.5 if weighted else None
    tgt = torch.rand(S, device=cuda) + 1.0 \
        if semiring == "arg_min_plus" else None
    got = slab_sweep(g.keys, g.slab_vertex, values, w, f, tgt,
                     semiring=semiring, n_vertices=V)
    want = slab_sweep_ref(g.keys, g.slab_vertex, values, semiring=semiring,
                          n_vertices=V, weights=w, frontier=f, target=tgt)
    torch.cuda.synchronize()
    if semiring == "sum":
        torch.testing.assert_close(got, want, rtol=1e-6,
                                   atol=1e-6 * float(want.abs().max()))
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("semiring", ["sum", "min", "min_plus"])
def test_sweep_int32_values(cuda, graph, semiring):
    _, _, _, g = graph
    labels = torch.randperm(g.n_vertices, device=cuda).to(torch.int32)
    got = slab_sweep(g.keys, g.slab_vertex, labels, semiring=semiring,
                     n_vertices=g.n_vertices)
    want = slab_sweep_ref(g.keys, g.slab_vertex, labels, semiring=semiring,
                          n_vertices=g.n_vertices)
    assert torch.equal(got, want)


#: lanes filled in the rows of the packed-prefix pools: around each 32-lane
#: step of the kernels' reads
FILLS = (0, 1, 7, 8, 31, 32, 33, 63, 64, 65, 95, 96, 97, 127, 128)
EMPTY, TOMBSTONE = -2, -3


def _packed_rows(rng, V):
    """(S, 128) packed rows at every fill of ``FILLS``: vertex keys, some
    rows of tombstones only, some with tombstones before the first EMPTY
    lane, some keys at or above V (not vertices), and unallocated rows
    (owner -1, all EMPTY)."""
    fills = np.tile(FILLS, 40)
    S = len(fills) + 64
    keys = np.full((S, 128), EMPTY, np.int32)
    owner = np.full(S, -1, np.int32)
    for r, f in enumerate(fills):
        keys[r, :f] = rng.integers(0, V, f)
        kind = r % 5
        if kind == 1:
            keys[r, :f] = TOMBSTONE
        elif kind == 2:
            keys[r, :f][rng.random(f) < 0.3] = TOMBSTONE
        elif kind == 3:
            keys[r, :f][rng.random(f) < 0.2] = V + rng.integers(0, 9, 1)
        owner[r] = rng.integers(0, V)
    perm = rng.permutation(S)
    return keys[perm], owner[perm]


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("frontier", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_sweep_reads_packed_prefixes(cuda, graph, semiring, frontier,
                                     weighted):
    """The sweep on rows filled to every step boundary, tombstone rows and
    unallocated rows, and on a pool with multi-slab chains after deletes,
    against its plain version."""
    rng = np.random.default_rng(7)
    V = 5000
    keys, owner = _packed_rows(rng, V)
    pools = [(torch.from_numpy(keys).to(cuda),
              torch.from_numpy(owner).to(cuda))]
    g = _churned(cuda, graph)
    pools.append((g.keys, g.slab_vertex))
    values = torch.rand(V, device=cuda) * 5
    f = (torch.rand(V, device=cuda) < 0.5) if frontier else None
    for k, o in pools:
        S = k.shape[0]
        w = torch.rand(S, 128, device=cuda) + 0.5 if weighted else None
        tgt = torch.rand(S, device=cuda) + 2.0 \
            if semiring == "arg_min_plus" else None
        before = runtime.LAUNCHES["slab_sweep"]
        got = slab_sweep(k, o, values, w, f, tgt, semiring=semiring,
                         n_vertices=V)
        want = slab_sweep_ref(k, o, values, semiring=semiring,
                              n_vertices=V, weights=w, frontier=f,
                              target=tgt)
        torch.cuda.synchronize()
        assert runtime.LAUNCHES["slab_sweep"] == before + 1
        if semiring == "sum":
            torch.testing.assert_close(got, want, rtol=1e-6,
                                       atol=1e-6 * float(want.abs().max()))
        else:
            assert torch.equal(got, want)
        assert bool((want != want[o < 0][0]).any())   # not all identity


def test_engine_on_card_matches_cpu(cuda, graph):
    """One mixed epoch through the engine on the card and on the CPU."""
    rng, src, dst, _ = graph
    V = 5000
    gc = from_edges_host(V, src, dst, hashing=False, device=cuda)
    gh = from_edges_host(V, src, dst, hashing=False, device="cpu")
    s, d = rng.integers(0, V, 2048), rng.integers(0, V, 2048)
    out = []
    for g, dev in ((gc, cuda), (gh, torch.device("cpu"))):
        g, dm = tbatch.delete_edges(g, _ids(src[:512], dev),
                                    _ids(dst[:512], dev))
        g, im = tbatch.insert_edges(g, _ids(s, dev), _ids(d, dev))
        out.append(dict(vars(g), im=im, dm=dm))
    for name in ("keys", "next_slab", "slab_vertex", "tail_slab",
                 "tail_fill", "upd_flag", "upd_slab", "upd_lane",
                 "next_free", "degree", "n_edges", "im", "dm"):
        assert torch.equal(out[0][name].cpu(), out[1][name]), name
    with pytest.raises(ValueError):
        tbatch.query_edges(gc, _ids(s, cuda), _ids(d, cuda), impl="torch")


def _churned(cuda, graph):
    """The fixture's edges and a hub of 1,000 distinct out-edges (an
    eight-slab chain) after a delete epoch: tombstones, dead lanes along
    the hub's chain, and a key at or above 2**31 in one row."""
    rng, src, dst, _ = graph
    src = np.concatenate([src, np.full(1000, 11)])
    dst = np.concatenate([dst, np.arange(1000)])
    g = from_edges_host(5000, src, dst, hashing=False, device=cuda)
    g, _ = tbatch.delete_edges(g, _ids(src[::3], cuda), _ids(dst[::3], cuda))
    g.keys[3, 5] = -7                        # uint32 id 2**32 - 7: live
    return g


def test_census_matches_plain(cuda, graph):
    g = _churned(cuda, graph)
    before = runtime.LAUNCHES["slab_live"]
    got = slab_live(g.keys, g.slab_vertex)
    want = slab_live_torch(g.keys, g.slab_vertex)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["slab_live"] == before + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(got[0][g.slab_vertex < 0].abs().sum()) == 0


def test_chain_walk_matches_plain(cuda, graph):
    g = _churned(cuda, graph)
    cnt, _ = slab_live(g.keys, g.slab_vertex)
    before = runtime.LAUNCHES["slab_chain_rank"]
    got = chain_rank(g.next_slab, cnt, g.n_buckets)
    want = chain_rank_torch(g.next_slab, cnt, g.n_buckets)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["slab_chain_rank"] == before + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(got[2].max()) >= 7            # the hub's chain was walked


def relabelled(keys, next_slab, owner, n_buckets: int, seed: int = 0):
    """The same chains with the overflow rows (``n_buckets`` up) relabelled
    by a seeded permutation, so that almost no link is ``r -> r + 1``."""
    S, dev = next_slab.shape[0], next_slab.device
    perm = torch.arange(S, device=dev)
    gen = torch.Generator().manual_seed(seed)
    perm[n_buckets:] = n_buckets + torch.randperm(
        S - n_buckets, generator=gen).to(dev)
    k, o = torch.empty_like(keys), torch.empty_like(owner)
    k[perm], o[perm] = keys, owner
    n = torch.full_like(next_slab, -1)
    n[perm] = torch.where(next_slab >= 0,
                          perm[next_slab.clamp_min(0).long()].to(torch.int32),
                          next_slab)
    return k, n, o


def _probe_and_walk(keys, nxt, owner, n_buckets, start, d):
    """Both kernels against their plain versions on one pool: the probe's
    three outputs and the chain walk's four, each launched once."""
    before = (runtime.LAUNCHES["slab_probe"],
              runtime.LAUNCHES["slab_chain_rank"])
    got = slab_probe(keys, nxt, start, d)
    want = slab_probe_torch(keys, nxt, start, d)
    cnt, _ = slab_live_torch(keys, owner)
    walk = chain_rank(nxt, cnt, n_buckets)
    walk_want = chain_rank_torch(nxt, cnt, n_buckets)
    torch.cuda.synchronize()
    assert (runtime.LAUNCHES["slab_probe"],
            runtime.LAUNCHES["slab_chain_rank"]) == (before[0] + 1,
                                                     before[1] + 1)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(walk, walk_want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    return got, walk


@pytest.mark.parametrize("layout", ["as built", "permuted"])
def test_probe_and_chain_walk_on_a_hub(cuda, layout):
    """A hub of 40,000 out-edges (a 313-slab chain): a probe for every key
    it holds (a hit at every chain position), for absent keys and inactive
    queries, and the chain walk, on the pool as built (consecutive overflow
    runs) and with its overflow rows relabelled."""
    rng = np.random.default_rng(3)
    V, hub = 5000, 40000
    src = np.concatenate([np.full(hub, 9), rng.integers(0, V, 20000)])
    dst = np.concatenate([rng.choice(10 ** 6, hub, replace=False),
                          rng.integers(0, V, 20000)])
    g = from_edges_host(V, src, dst, hashing=False, device=cuda)
    keys, nxt, owner = g.keys, g.next_slab, g.slab_vertex
    if layout == "permuted":
        keys, nxt, owner = relabelled(keys, nxt, owner, g.n_buckets)
    consecutive = int((nxt[g.n_buckets:] == torch.arange(
        g.n_buckets + 1, g.capacity_slabs + 1, device=cuda)).sum())
    assert consecutive >= 311 if layout == "as built" else consecutive < 10
    start = _ids(np.concatenate([np.full(hub + 512, 9),
                                 rng.integers(0, V, 512)]), cuda)
    start[-64:] = -1
    d = _ids(np.concatenate([dst[:hub], 10 ** 6 + np.arange(512),
                             rng.integers(0, V, 512)]), cuda)
    got, walk = _probe_and_walk(keys, nxt, owner, g.n_buckets, start, d)
    assert bool(got[0][:hub].all()) and not bool(got[0][hub:hub + 512].any())
    assert int(walk[2].max()) == 312


def _run_pool(rng, chains, S=1024, n_buckets=8):
    """A packed pool of ``S`` rows whose bucket ``b`` chains through the
    rows ``chains[b]`` after its head row ``b``: every row full of distinct
    keys (``1000 * row + lane``), each tail half full."""
    keys = np.full((S, 128), -2, np.int32)
    nxt = np.full(S, -1, np.int32)
    owner = np.full(S, -1, np.int32)
    for b, rows in enumerate(chains):
        rows = [b] + list(rows)
        for i, r in enumerate(rows):
            fill = 128 if i + 1 < len(rows) else 64
            keys[r, :fill] = 1000 * r + np.arange(fill)
            owner[r] = b
            nxt[r] = rows[i + 1] if i + 1 < len(rows) else -1
    return keys, nxt, owner


@pytest.mark.parametrize("run", [31, 32, 33, "to the pool's last row"])
def test_probe_and_chain_walk_on_runs(cuda, run):
    """Chains of consecutive runs exactly one window long, one row either
    side of it, and a run that ends at the pool's last row (its window
    reaches past the pool), against links that are not consecutive: a
    probe for every key of every chain, absent keys and inactive queries,
    and the chain walk."""
    rng = np.random.default_rng(4)
    S = 1024
    if run == "to the pool's last row":
        # bucket 0 ends at row S - 1; bucket 3's run stops just before it
        first = [list(range(600, 640)), list(range(S - 40, S))]
        last = list(range(S - 100, S - 40))
    else:
        first = [list(range(100, 100 + run)), list(range(300, 300 + run))]
        last = list(range(500, 500 + 2 * run))
    chains = [first[0] + first[1],                     # run, jump, run
              [700, 702, 701, 703],                    # no link consecutive
              [],                                      # the head alone
              last]
    keys, nxt, owner = _run_pool(rng, chains, S=S)
    rows = np.nonzero(owner >= 0)[0]
    held = keys[rows][keys[rows] >= 0]
    qrow = held // 1000
    start = np.concatenate([owner[qrow], np.arange(8), [-1] * 8])
    d = np.concatenate([held, 10 ** 7 + np.arange(8), held[:8]])
    t = [torch.from_numpy(a).to(cuda) for a in (keys, nxt, owner)]
    got, walk = _probe_and_walk(*t, 8, torch.from_numpy(start.astype(
        np.int32)).to(cuda), _ids(d, cuda))
    n = len(held)
    assert bool(got[0][:n].all()) and not bool(got[0][n:].any())
    assert torch.equal(got[1][:n].cpu(), torch.from_numpy(qrow.astype(
        np.int32)))


def test_probe_takes_the_first_hit(cuda):
    """A key in two lanes of one row, and in two rows of one chain (both
    inside a run, and one past a window's end): the earliest row, then the
    lowest lane, as the plain version."""
    rng = np.random.default_rng(5)
    keys, nxt, owner = _run_pool(rng, [list(range(100, 180))], S=512,
                                 n_buckets=1)
    k = 2 * 10 ** 6 + np.arange(4)             # keys no row holds yet
    keys[102, [70, 5]] = k[0]                  # chain position 3
    keys[140, 9] = k[0]                        # position 41
    keys[133, [90, 3]] = k[1]                  # position 34
    keys[179, 1] = k[1]                        # the tail
    keys[101, 127] = k[2]                      # position 2, last lane
    keys[150, 0] = k[2]
    keys[105, 50] = k[3]                       # two rows of one step
    keys[104, 60] = k[3]
    t = [torch.from_numpy(a).to(cuda) for a in (keys, nxt, owner)]
    start = torch.zeros(4, dtype=torch.int32, device=cuda)
    got, _ = _probe_and_walk(*t, 1, start, _ids(k, cuda))
    assert got[1].tolist() == [102, 133, 101, 104]
    assert got[2].tolist() == [5, 3, 127, 60]


def test_probe_stops_on_a_corrupt_chain(cuda):
    """A chain that cycles (a run that links back to its start, and a row
    that links to itself) ends after as many rows as the pool has instead
    of hanging the card; a key on the cycle is still found."""
    rng = np.random.default_rng(6)
    keys, nxt, owner = _run_pool(rng, [list(range(100, 140)), [300]], S=512,
                                 n_buckets=2)
    nxt[139] = 100
    nxt[300] = 300
    t = [torch.from_numpy(a).to(cuda) for a in (keys, nxt, owner)]
    start = torch.tensor([0, 0, 1, 1], dtype=torch.int32, device=cuda)
    d = _ids([1000 * 120 + 3, 10 ** 7, 1000 * 300 + 1, 10 ** 7], cuda)
    found, slab, lane = slab_probe(t[0], t[1], start, d)
    torch.cuda.synchronize()
    assert found.tolist() == [True, False, True, False]
    assert slab.tolist() == [120, -1, 300, -1]
    assert lane.tolist() == [3, -1, 1, -1]
    cnt, _ = slab_live_torch(t[0], t[2])
    chain_rank(t[1], cnt, 2)
    torch.cuda.synchronize()


def test_compaction_on_card_matches_cpu(cuda, graph):
    g = _churned(cuda, graph)
    host = slab_graph_from_numpy(slab_graph_to_numpy(g), "cpu")
    gc, rc = compact(g)
    gh, rh = compact(host)
    for name in FIELDS:
        a, b = getattr(gc, name), getattr(gh, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a.cpu(), b), name
    assert torch.equal(rc.perm.cpu(), rh.perm)
    assert (rc.new_capacity, rc.live_lanes) == (rh.new_capacity,
                                                rh.live_lanes)


def _open_epoch(cuda, graph):
    """The fixture's edges on the card and on the CPU, each with one
    insert epoch left open through the engine: (card graph, CPU graph,
    the card's batch)."""
    rng, src, dst, _ = graph
    V = 5000
    s = np.concatenate([np.full(512, 7), rng.integers(0, V, 3584)])
    d = rng.integers(0, V, 4096)
    out = []
    for dev in (cuda, torch.device("cpu")):
        g = ensure_capacity(from_edges_host(V, src, dst, hashing=False,
                                            device=dev), 4096 + 64)
        g, _ = tbatch.insert_edges(g, _ids(s, dev), _ids(d, dev))
        out.append(g)
    return out[0], out[1], (_ids(s, cuda), _ids(d, cuda))


def test_engine_on_card_matches_the_oracle(cuda, graph):
    """The engine's insert (kernels 1 and 2) against ``insert_edges_ref``
    on the card, on a pool with a hub chain; the oracle leaves its input
    as it was."""
    rng, src, dst, _ = graph
    V = 5000
    s = np.concatenate([np.full(512, 7), rng.integers(0, V, 3584)])
    d = rng.integers(0, V, 4096)
    base = ensure_capacity(from_edges_host(V, src, dst, hashing=False,
                                           device=cuda), 4096 + 64)
    before = slab_graph_to_numpy(base)
    oracle, om = insert_edges_ref(base, _ids(s, cuda), _ids(d, cuda))
    for name in FIELDS:
        if before[name] is not None:
            assert np.array_equal(getattr(base, name).cpu().numpy(),
                                  before[name]), name
    launched = runtime.LAUNCHES["slab_commit"]
    g, em = tbatch.insert_edges(base, _ids(s, cuda), _ids(d, cuda))
    assert runtime.LAUNCHES["slab_commit"] > launched
    assert torch.equal(em, om)
    for name in FIELDS:
        a, b = getattr(g, name), getattr(oracle, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name


def test_iterators_on_card_match_cpu(cuda, graph):
    """The worklist functions and the iterators of an open epoch, on the
    card and on the CPU."""
    gc, gh, _ = _open_epoch(cuda, graph)
    for a, b in ((updated_lane_mask(gc), updated_lane_mask(gh)),
                 (updated_vertices(gc), updated_vertices(gh))):
        assert torch.equal(a.cpu(), b)
    for fc, fh in ((updated_edges(gc, max_buckets=4096, out_capacity=8192),
                    updated_edges(gh, max_buckets=4096, out_capacity=8192)),
                   (csr_snapshot(gc, max_edges=1 << 17),
                    csr_snapshot(gh, max_edges=1 << 17))):
        for a, b in zip(fc, fh):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a.cpu(), b)
    for fn in (slab_iterator, update_iterator):
        for a, b in zip(fn(gc, 7, max_neighbors=2048),
                        fn(gh, 7, max_neighbors=2048)):
            assert torch.equal(a.cpu(), b)
    assert occupancy_stats(gc) == occupancy_stats(gh)


def test_bfs_vanilla_and_wcc_schemes_on_card_match_cpu(cuda, graph):
    """Both bodies of ``bfs_vanilla`` (the swept one through kernel 3's
    int32 ``sum``) and the four incremental WCC schemes, on the card and on
    the CPU."""
    gc, gh, (s, d) = _open_epoch(cuda, graph)
    levels = []
    for g, dev in ((gc, cuda), (gh, "cpu")):
        tr = transpose_host(g, device=dev)
        launched = runtime.LAUNCHES["slab_sweep"]
        swept, it = bfs_vanilla(g, src=7, edge_capacity=1 << 17, g_in=tr)
        if dev is cuda:
            assert runtime.LAUNCHES["slab_sweep"] - launched == it
        expanded, it2 = bfs_vanilla(g, src=7, edge_capacity=1 << 17)
        assert torch.equal(swept, expanded) and it == it2
        levels.append(swept.cpu())
    assert torch.equal(levels[0], levels[1])
    labels = []
    for g, bs, bd in ((gc, s, d), (gh, s.cpu(), d.cpu())):
        before = init_parents(g.n_vertices, g.device)
        mask = torch.ones(bs.shape[0], dtype=torch.bool, device=g.device)
        got = [wcc_static(g), wcc_incremental_naive(before, g),
               wcc_incremental_batch(wcc_static(g), bs, bd, mask),
               wcc_incremental_slab_iterator(before, g, cap=1 << 17),
               wcc_incremental_update_iterator(before, g, cap=8192)]
        labels.append([t.cpu() for t in got])
    for a, b in zip(*labels):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def undirected(cuda):
    """A hashed symmetric graph with a hub of several buckets, on the card
    and on the CPU, and its loop-free undirected edges."""
    rng = np.random.default_rng(1)
    V, E = 3000, 40000
    src = rng.integers(0, V, E)
    dst = rng.integers(0, V, E)
    src[:2000] = 5
    keep = src != dst
    lo, hi = ttri.undirected_host(src[keep], dst[keep])
    s2, d2 = np.concatenate([lo, hi]), np.concatenate([hi, lo])
    return rng, V, lo, hi, [from_edges_host(V, s2, d2, hashing=True,
                                            device=dev)
                            for dev in (cuda, "cpu")]


def _items(g2, lo, hi, rng, dev):
    n = 2048
    mask = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    return _work_items(g2, _ids(lo[:n], dev), _ids(hi[:n], dev), mask,
                       max_bpv=ttri._sym_bpv(g2))


@pytest.mark.parametrize("g2_kind", ["same", "batch graph"])
def test_slab_count_matches_plain(cuda, undirected, g2_kind):
    rng, V, lo, hi, (g, _) = undirected
    g2 = g
    if g2_kind == "batch graph":
        b = 512
        g2 = ttri.batch_graph(V, _ids(lo[-b:], cuda), _ids(hi[-b:], cuda),
                              torch.ones(b, dtype=torch.bool, device=cuda))
    start, us = _items(g2, lo, hi, rng, cuda)
    assert int((start != -1).sum()) > 0
    args = (g.keys, g.next_slab, g.bucket_offset, g.bucket_count, g2.keys,
            g2.next_slab, start, us)
    before = runtime.LAUNCHES["slab_count"]
    got = slab_count(*args)
    want = slab_count_torch(*args)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["slab_count"] == before + 1
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert int(want.sum()) > 0


def test_slab_count_stops_on_a_corrupt_chain(cuda, undirected):
    """A chain that loops on itself ends after as many hops as the pool
    has rows instead of hanging the card."""
    rng, _, lo, hi, (g, _) = undirected
    start, us = _items(g, lo, hi, rng, cuda)
    nxt = g.next_slab.clone()
    row = int(start[start != -1][0])
    nxt[row] = row
    slab_count(g.keys, nxt, g.bucket_offset, g.bucket_count, g.keys, nxt,
               start, us)
    torch.cuda.synchronize()


def _bucket_pool(rng, fills, universe=8192):
    """A packed G1 = G2 of ``len(fills)`` vertices: vertex v has
    ``len(fills[v])`` buckets, bucket b a chain holding ``fills[v][b]``
    distinct ids below ``universe`` that hash to b (its tail filled to
    fills mod 128, or 128), a tenth of them tombstoned.  Heads first, then
    the overflow rows, as the engine lays them out."""
    ids = np.arange(universe, dtype=np.uint64)
    h = ((ids * 2654435761) & 0xFFFFFFFF) >> 8
    bcnt = np.array([len(f) for f in fills], np.int32)
    boff = np.zeros(len(fills) + 1, np.int32)
    np.cumsum(bcnt, out=boff[1:])
    rows = int(boff[-1]) + sum(max(0, -(-n // 128) - 1)
                               for f in fills for n in f)
    keys = np.full((rows, 128), EMPTY, np.int32)
    nxt = np.full(rows, -1, np.int32)
    spare = int(boff[-1])
    for v, fv in enumerate(fills):
        for b, n in enumerate(fv):
            ks = rng.choice(ids[h % len(fv) == b], n,
                            replace=False).astype(np.int64)
            ks = np.where(rng.random(n) < 0.1, TOMBSTONE, ks)
            row = boff[v] + b
            for c0 in range(0, n, 128):
                part = ks[c0:c0 + 128]
                keys[row, :len(part)] = part
                if c0 + 128 < n:
                    nxt[row], row = spare, spare
                    spare += 1
    return keys, nxt, boff, bcnt


@pytest.mark.parametrize("layout", ["one bucket", "four buckets"])
def test_slab_count_on_step_boundaries(cuda, layout):
    """Chains whose tail fill lies on each side of every 32-lane step,
    through the one-bucket (a probe a thread) and the multi-bucket (a probe
    a group) paths, with hub-heavy items; and an empty item list."""
    rng = np.random.default_rng(3)
    ends = [128 * k + f for k in (0, 1, 2) for f in FILLS[1:]]
    if layout == "one bucket":
        fills = [[n] for n in ends]
    else:
        fills = [list(rng.choice(ends, 4)) for _ in range(len(ends))]
    keys, nxt, boff, bcnt = _bucket_pool(rng, fills)
    n_v = len(fills)
    hub = int(np.argmax([sum(f) for f in fills]))
    us = rng.integers(0, n_v, 3000)
    vs = np.where(rng.random(3000) < 0.5, hub, rng.integers(0, n_v, 3000))
    start = np.concatenate([boff[v] + np.arange(bcnt[v]) for v in vs])
    u_it = np.repeat(us, bcnt[vs])
    start[::97] = -1                                # inactive items too
    t = [torch.from_numpy(a.astype(np.int32)).to(cuda)
         for a in (keys, nxt, boff, bcnt, start, u_it)]
    args = (t[0], t[1], t[2], t[3], t[0], t[1], t[4], t[5])
    before = runtime.LAUNCHES["slab_count"]
    got = slab_count(*args)
    want = slab_count_torch(*args)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["slab_count"] == before + 1
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert int(want.sum()) > 0
    none = t[4][:0]
    got = slab_count(*args[:6], none, none)
    assert got.shape == (0,)
    assert runtime.LAUNCHES["slab_count"] == before + 1   # nothing launched


def test_probe_hits_matches_plain(cuda, undirected):
    rng, V, lo, hi, (g, _) = undirected
    Q = 4096
    qs = np.concatenate([lo[:Q // 2], rng.integers(0, V, Q // 2)])
    qd = np.concatenate([hi[:Q // 2], rng.integers(0, V, Q // 2)])
    mask = torch.ones(Q, dtype=torch.bool, device=cuda)
    rows = materialize_chains(g, _ids(qs, cuda), _ids(qd, cuda), mask,
                              max_chain=4)
    before = runtime.LAUNCHES["probe_hits"]
    got = probe_hits(_ids(qd, cuda), rows, g.keys)
    want = probe_hits_torch(_ids(qd, cuda), rows, g.keys)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["probe_hits"] == before + 1
    assert torch.equal(got, want)
    assert bool(got[:Q // 2].all())


#: kernel 8's edge cases (name, Q, C): C of 1, 3, 8, 13 and 40 (walks of
#: one to 40 rows), -1 pads inside a row list, row ids at or past the pool
#: (skipped), a hit only in a query's last row, no hit at all, and Q not a
#: multiple of a block's queries
PROBE_CASES = [("C=1", 1000, 1), ("C=3", 1000, 3), ("C=8", 1000, 8),
               ("C=13", 500, 13), ("C=40", 300, 40),
               ("pads inside", 777, 6), ("rows past S", 500, 4),
               ("last row hits", 600, 5), ("no hit", 600, 8),
               ("ragged Q", 37, 2)]


def probe_inputs(name, Q, C, seed=0):
    """int32 ``ws`` (Q,), ``rows`` (Q, C) and ``keys`` (1024, 128) of a
    ``PROBE_CASES`` entry; ``rows`` with every id past the pool as -1 (what
    the plain version, which reads every id it is given, takes); and the
    answers planted, (Q,) bool: each key is in no row but where a hit is
    planted."""
    rng = np.random.default_rng(seed)
    S = 1024
    keys = rng.integers(0, 5000, (S, 128))
    keys[::5, 100:] = EMPTY                           # row tails
    rows = rng.integers(0, S, (Q, C))
    ws = 10000 + np.arange(Q)                         # in no row yet
    if name in ("last row hits", "no hit"):
        rows[:, -1] = rng.permutation(S)[:Q]          # a row per query
    else:
        rows[rng.random((Q, C)) < 0.2] = -1
    if name == "pads inside":
        rows[:, 1:-1:2] = -1
    if name == "rows past S":
        rows[rng.random((Q, C)) < 0.3] = S + rng.integers(0, 1 << 30)
        rows[::9, 0] = 2 ** 31 - 1
    planted = np.zeros(Q, bool)
    if name == "last row hits":
        keys[rows[:, -1], rng.integers(0, 128, Q)] = ws
        planted[:] = True
    elif name != "no hit":
        # a hit for every other query, in its first or last valid row, at
        # a lane no other query's hit takes
        used = np.zeros(S, np.int64)
        for i in range(0, Q, 2):
            valid = [r for r in rows[i] if 0 <= r < S]
            if valid:
                r = valid[-1] if i % 4 else valid[0]
                keys[r, used[r]] = ws[i]
                used[r] += 1
                planted[i] = True
    plain = np.where(rows < S, rows, -1)
    return [a.astype(np.int32) for a in (ws, rows, keys, plain)] + [planted]


@pytest.mark.parametrize("case", PROBE_CASES,
                         ids=[c[0] for c in PROBE_CASES])
def test_probe_hits_cases(cuda, case):
    *arrays, planted = probe_inputs(*case)
    ws, rows, keys, plain = (torch.from_numpy(a).to(cuda) for a in arrays)
    before = runtime.LAUNCHES["probe_hits"]
    got = probe_hits(ws, rows, keys)
    want = probe_hits_torch(ws, plain, keys)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["probe_hits"] == before + 1
    assert torch.equal(got, want)
    assert np.array_equal(got.cpu().numpy(), planted)


def test_count_edges_on_card_matches_cpu(cuda, undirected):
    rng, _, lo, hi, (gc, gh) = undirected
    n = 4096
    mask = rng.random(n) < 0.9
    mb = ttri._sym_bpv(gh)
    out = []
    for g, dev in ((gc, cuda), (gh, torch.device("cpu"))):
        out.append(int(count_edges(
            g, g, _ids(lo[:n], dev), _ids(hi[:n], dev),
            torch.from_numpy(mask).to(dev), max_bpv=mb)))
    assert out[0] == out[1] > 0
    assert int(ttri.triangles_static(gc, max_bpv=mb)) == \
        int(ttri.triangles_static(gh, max_bpv=mb))


# ----------------------------------------------------------------------------
# flash attention and EmbeddingBag
# ----------------------------------------------------------------------------

# (B, Hq, Hkv, Sq, Skv, D, causal, window, softcap, dtype, extra kwargs):
# tests/test_kernels.py's sweep, then kv_len, Sq > Skv, head_dim 256,
# sm_scale and a query tile with no visible key
ATTN_CASES = [
    (1, 4, 4, 128, 128, 64, True, 0, 0.0, "float32", {}),
    (2, 4, 2, 256, 256, 64, True, 0, 0.0, "float32", {}),
    (1, 4, 1, 128, 128, 64, True, 0, 0.0, "float32", {}),
    (1, 2, 2, 256, 256, 64, True, 64, 0.0, "float32", {}),
    (1, 2, 2, 128, 128, 64, True, 0, 30.0, "float32", {}),
    (1, 2, 2, 128, 128, 64, False, 0, 0.0, "float32", {}),
    (1, 2, 1, 128, 256, 128, True, 0, 0.0, "bfloat16", {}),
    (1, 4, 2, 256, 256, 64, True, 128, 50.0, "float32", {}),
    (1, 2, 2, 128, 256, 64, False, 0, 0.0, "float32", {"kv_len": 130}),
    (1, 2, 2, 256, 128, 64, True, 0, 0.0, "float32", {}),
    (1, 4, 2, 128, 128, 256, True, 64, 50.0, "float32", {}),
    (1, 4, 2, 128, 128, 256, True, 64, 50.0, "bfloat16", {}),
    (1, 2, 1, 128, 128, 128, True, 0, 0.0, "float32", {"sm_scale": 0.3}),
    (1, 2, 2, 128, 128, 64, True, 0, 0.0, "float32", {"kv_len": 0}),
    # the bf16 twin of each float32 row above (the tensor-core kernel),
    # in the same order
    (1, 4, 4, 128, 128, 64, True, 0, 0.0, "bfloat16", {}),
    (2, 4, 2, 256, 256, 64, True, 0, 0.0, "bfloat16", {}),
    (1, 4, 1, 128, 128, 64, True, 0, 0.0, "bfloat16", {}),
    (1, 2, 2, 256, 256, 64, True, 64, 0.0, "bfloat16", {}),
    (1, 2, 2, 128, 128, 64, True, 0, 30.0, "bfloat16", {}),
    (1, 2, 2, 128, 128, 64, False, 0, 0.0, "bfloat16", {}),
    (1, 4, 2, 256, 256, 64, True, 128, 50.0, "bfloat16", {}),
    (1, 2, 2, 128, 256, 64, False, 0, 0.0, "bfloat16", {"kv_len": 130}),
    (1, 2, 2, 256, 128, 64, True, 0, 0.0, "bfloat16", {}),
    (1, 2, 1, 128, 128, 128, True, 0, 0.0, "bfloat16", {"sm_scale": 0.3}),
    (1, 2, 2, 128, 128, 64, True, 0, 0.0, "bfloat16", {"kv_len": 0}),
    # the served shapes of qwen1.5-32b (MHA 40/40, head_dim 128) and
    # gemma-2b (MQA 8/1, head_dim 256), and a ragged tile: Sq and the
    # window multiples of neither 16 nor 64
    (1, 40, 40, 128, 128, 128, True, 0, 0.0, "bfloat16", {}),
    (1, 8, 1, 128, 128, 256, True, 0, 0.0, "bfloat16", {}),
    (1, 4, 2, 77, 77, 128, True, 40, 50.0, "bfloat16", {}),
    # float32 at the CUDA-core kernel's tile edges (128-row query tiles, 16
    # rows a warp, 32-key tiles): Sq and kv_len multiples of none of them,
    # a window edge inside a key tile, GQA 4:1 at head_dim 256, Sq > Skv
    (1, 4, 2, 200, 200, 128, True, 0, 0.0, "float32", {}),
    (1, 2, 2, 150, 300, 64, False, 0, 30.0, "float32", {"kv_len": 201}),
    (1, 2, 1, 300, 300, 128, True, 50, 50.0, "float32", {}),
    (1, 8, 2, 160, 160, 256, True, 0, 50.0, "float32", {}),
    (2, 4, 1, 300, 260, 64, True, 100, 0.0, "float32", {"kv_len": 250}),
]
# gemma2-9b's attention at a card-sized length: bf16, head_dim 256, GQA
# 16/8, a window and softcap 50, and a ragged length (not a tile multiple)
GEMMA2_CASE = (2, 16, 8, 1000, 1000, 256, True, 256, 50.0, "bfloat16", {})
# the backward's work-list edges: MQA 8/1 at head_dim 256 over 1,000 tokens
# (no multiple of the 64- or 32-key tiles; many items share a key tile),
# with a window and softcap, and Sq != Skv under a window (more queries
# than keys; fewer, non-causal, kv_len inside a tile), in both dtypes
BWD_EDGE_CASES = [
    (1, 8, 1, 1000, 1000, 256, True, 0, 0.0, "bfloat16", {}),
    (1, 8, 1, 1000, 1000, 256, True, 300, 50.0, "bfloat16", {}),
    (1, 4, 2, 700, 333, 128, True, 150, 0.0, "bfloat16", {}),
    (1, 4, 2, 333, 700, 64, False, 90, 30.0, "bfloat16", {"kv_len": 650}),
    (1, 8, 1, 1000, 1000, 256, True, 0, 0.0, "float32", {}),
    (1, 4, 2, 700, 333, 128, True, 150, 0.0, "float32", {}),
    (1, 4, 2, 333, 700, 64, False, 90, 30.0, "float32", {"kv_len": 650}),
]
#: the backward in bf16 against attention_bwd_ref, per output:
#: |kernel - plain| <= atol_rel * max|plain| + rtol * |plain|
#: (chip_smoke.py's BWD_TOL)
BWD_BF16_TOL = (1e-3, 2e-2)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _attn_inputs(case, dev, seed=0):
    B, Hq, Hkv, Sq, Skv, D, *_, dtype, _ = case
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(DTYPES[dtype])
            for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))]


@pytest.mark.parametrize("case", ATTN_CASES + [GEMMA2_CASE],
                         ids=[f"attn{i}" for i in range(len(ATTN_CASES))]
                         + ["gemma2"])
def test_flash_attention_matches_plain(cuda, case):
    torch.backends.cuda.matmul.allow_tf32 = False   # a float32 plain version
    *_, causal, window, softcap, dtype, extra = case
    q, k, v = _attn_inputs(case, cuda)
    kw = dict(causal=causal, window=window, softcap=softcap, **extra)
    before = runtime.LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, **kw)
    want = attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if extra.get("kv_len") == 0:
        assert not got.any()


@pytest.mark.parametrize("D", [16, 32])
def test_flash_attention_narrow_head_matches_plain(cuda, D):
    """A head narrower than the kernels' HEAD_DIMS (the smoke configs' 16
    and 32: ``examples/torch_train_lm.py`` on the card) runs zero-padded to
    64 through kernel 10 and its backward, against ``attention_ref`` and
    its autograd in float32, gemma2's window and softcap."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, do = (torch.randn(s, generator=g, device=cuda) for s in
                   ((2, 4, 64, D), (2, 2, 64, D), (2, 2, 64, D),
                    (2, 4, 64, D)))
    kw = dict(causal=True, window=8, softcap=50.0)
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(runtime.LAUNCHES)
    got = flash_attention(*ts, **kw)
    grads = torch.autograd.grad(got, ts, do)
    assert runtime.LAUNCHES["flash_attention"] == \
        before["flash_attention"] + 1
    assert runtime.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    refs = [t.clone().requires_grad_() for t in (q, k, v)]
    want = attention_ref(*refs, **kw)
    want_grads = torch.autograd.grad(want, refs, do)
    assert got.shape == q.shape
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    for a, b in zip(grads, want_grads):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


#: (B, L, D, dtype, table): D of every path (16-byte loads with a row of
#: 1, 2, 16 or 32+ lanes; scalar loads where the vector does not divide D);
#: L of one slot, one and two 32-slot ballots, a 64-slot stage and four;
#: B = 1 and 512 (bags split over a block's warps) and 2,000 (a warp a
#: bag); a bf16 table 4 bytes past a 16-byte edge (the scalar path)
BAG_CASES = (
    [(2000, 50, D, dt, "aligned") for D in (1, 8, 33, 64, 100, 128, 256)
     for dt in ("float32", "bfloat16")]
    + [(512, L, 64, dt, "aligned") for L in (1, 32, 33, 50, 200)
       for dt in ("float32", "bfloat16")]
    + [(1, 200, 64, "float32", "aligned"), (1, 50, 256, "bfloat16", "aligned"),
       (2000, 50, 64, "bfloat16", "offset"), (512, 50, 8, "bfloat16", "offset")])


@pytest.mark.parametrize("B,L,D,dtype,table", BAG_CASES)
def test_embedding_bag_matches_plain(cuda, B, L, D, dtype, table):
    """Kernel 9 against its plain version, with all-pad bags, one row
    repeated through a bag, and indices at or past N (read as pads)."""
    rng = np.random.default_rng(4)
    N = 100000
    idx = (rng.zipf(1.2, (B, L)) % N).astype(np.int32)
    idx[rng.random((B, L)) < 0.3] = -1
    idx[rng.random((B, L)) < 0.03] = N + 5
    n_pad = min(17, B // 4)
    idx[:n_pad] = -1                                # all-pad bags
    if B > n_pad:
        idx[n_pad] = 4321                           # one row, every slot
    w = rng.standard_normal((B, L)).astype(np.float32)
    gen = torch.Generator(device=cuda).manual_seed(1)
    if table == "offset":
        flat = torch.randn(N * D + 2, generator=gen, device=cuda) \
            .to(DTYPES[dtype])
        tab = flat[2:].view(N, D)
        assert tab.data_ptr() % 16 == 4
    else:
        tab = torch.randn((N, D), generator=gen, device=cuda) \
            .to(DTYPES[dtype])
    ti, tw = torch.from_numpy(idx).to(cuda), torch.from_numpy(w).to(cuda)
    before = runtime.LAUNCHES["embedding_bag"]
    got = embedding_bag(ti, tw, tab)
    want = embedding_bag_ref(torch.where(ti < N, ti, -1), tw, tab)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["embedding_bag"] == before + 1
    assert got.dtype == tab.dtype and got.shape == (B, D)
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)
    assert not got[:n_pad].any()


@pytest.mark.parametrize("case", ATTN_CASES + [GEMMA2_CASE] + BWD_EDGE_CASES,
                         ids=[f"attn{i}" for i in range(len(ATTN_CASES))]
                         + ["gemma2"] + [f"bwd_edge{i}" for i in
                                         range(len(BWD_EDGE_CASES))])
def test_flash_attention_backward_matches_plain(cuda, case):
    """The forward with ``lse`` (the same output bits as without, ``lse``
    the plain version's), then the backward kernel through the op's
    autograd against ``attention_bwd_ref`` on the same (q, k, v, o, lse,
    dO), within ``BWD_BF16_TOL`` in bf16 and 1e-4 in float32, and a
    second backward launch bit-equal to the first."""
    torch.backends.cuda.matmul.allow_tf32 = False
    *_, causal, window, softcap, dtype, extra = case
    q, k, v = _attn_inputs(case, cuda)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda)
                     .manual_seed(5), device=cuda).to(q.dtype)
    D, Skv = q.shape[-1], k.shape[2]
    kw = dict(causal=causal, window=window, softcap=softcap,
              sm_scale=extra.get("sm_scale", D ** -0.5),
              kv_len=extra.get("kv_len", Skv))
    o, lse = attn_kernel.flash_attention_cuda(q, k, v, lse=True, **kw)
    assert torch.equal(o, attn_kernel.flash_attention_cuda(q, k, v, **kw))
    want_lse = attention_lse_ref(q, k, **kw)
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
    fin = torch.isfinite(want_lse)
    torch.testing.assert_close(lse[fin], want_lse[fin], atol=1e-5,
                               rtol=1e-5)
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(runtime.LAUNCHES)
    out = flash_attention(*ts, **kw)
    grads = torch.autograd.grad(out, ts, do)
    assert runtime.LAUNCHES["flash_attention"] == \
        before["flash_attention"] + 1
    assert runtime.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    assert torch.equal(out.detach(), o)
    want = attention_bwd_ref(q, k, v, o, lse, do, **kw)
    again = attn_kernel.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for name, g, w, a in zip(("dq", "dk", "dv"), grads, want, again):
        assert g.dtype == q.dtype and g.shape == w.shape, name
        assert torch.equal(g, a), f"{name}: two launches differ"
        gf, wf = g.float(), w.float()
        if dtype == "bfloat16":
            atol_rel, rtol = BWD_BF16_TOL
            err = (gf - wf).abs()
            assert not (err > atol_rel * wf.abs().max()
                        + rtol * wf.abs()).any(), \
                (name, float(err.max()), float(wf.abs().max()))
        else:
            torch.testing.assert_close(gf, wf, atol=1e-4, rtol=1e-4,
                                       msg=name)
    if extra.get("kv_len") == 0:
        assert not any(g.any() for g in grads)


def test_unbuildable_kernel_raises(cuda, tmp_path, monkeypatch):
    """A kernel that does not build raises on CUDA tensors; the op does not
    fall back to its plain version."""
    (tmp_path / "flash_attention.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(runtime, "CSRC", tmp_path)
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delitem(runtime._libs, "flash_attention", raising=False)
    q, k, v = _attn_inputs(ATTN_CASES[0], cuda)
    before = runtime.LAUNCHES["flash_attention"]
    with pytest.raises(RuntimeError, match="nvcc failed"):
        flash_attention(q, k, v)
    assert runtime.LAUNCHES["flash_attention"] == before


def test_unbuildable_backward_raises(cuda, tmp_path, monkeypatch):
    """A backward kernel that does not build raises from the op's backward
    on CUDA tensors; nothing falls back to the plain version."""
    (tmp_path / "flash_attention_bwd.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(runtime, "CSRC", tmp_path)
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delitem(runtime._libs, "flash_attention_bwd", raising=False)
    q, k, v = (t.requires_grad_() for t in _attn_inputs(ATTN_CASES[0], cuda))
    runtime.library("flash_attention")        # the forward is built already
    out = flash_attention(q, k, v)
    before = runtime.LAUNCHES["flash_attention_bwd"]
    with pytest.raises(RuntimeError, match="nvcc failed"):
        out.sum().backward()
    assert runtime.LAUNCHES["flash_attention_bwd"] == before


class _RefusedLaunch:
    """A kernel library whose every launch reports
    cudaErrorInvalidConfiguration (9)."""

    def __getattr__(self, name):
        if name.endswith("_error_string"):
            return lambda code: b"invalid configuration argument"
        return lambda *args: 9


def test_failed_launch_raises(cuda, monkeypatch):
    """A launch the card refuses raises, counts no launch and falls back to
    nothing."""
    q, k, v = (t.requires_grad_() for t in _attn_inputs(ATTN_CASES[0], cuda))
    out = flash_attention(q, k, v)
    monkeypatch.setattr(attn_kernel, "_lib", _RefusedLaunch)
    monkeypatch.setattr(attn_kernel, "_bwd_lib", _RefusedLaunch)
    monkeypatch.setattr(bag_kernel, "_lib", _RefusedLaunch)
    before = dict(runtime.LAUNCHES)
    with pytest.raises(RuntimeError, match="flash_attention launch failed"):
        flash_attention(q, k, v)
    with pytest.raises(RuntimeError,
                       match="flash_attention_bwd launch failed"):
        out.sum().backward()
    idx = torch.zeros((4, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="embedding_bag launch failed"):
        embedding_bag(idx, torch.ones((4, 3), device=cuda),
                      torch.ones((8, 64), device=cuda))
    assert runtime.LAUNCHES == before


def test_lm_on_card_matches_cpu(cuda):
    """A two-layer gemma2-style model (head_dim 64, window 64, softcaps,
    float32) on the card, through the kernel, against the same model on
    the CPU through the plain version; and decode after prefill against
    forward on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LMConfig(name="gemma2-card", n_layers=2, d_model=256, n_heads=4,
                   n_kv_heads=2, head_dim=64, d_ff=512, vocab_size=1024,
                   activation="geglu", sliding_window=64,
                   local_global_alternate=True, attn_softcap=50.0,
                   final_softcap=30.0, embed_scale=True, dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    host = TransformerLM(cfg, params)
    card = TransformerLM(cfg, {k: ({n: t.to(cuda) for n, t in v.items()}
                                   if isinstance(v, dict) else v.to(cuda))
                               for k, v in params.items()})
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 200)))
    before = runtime.LAUNCHES["flash_attention"]
    full = card(toks.to(cuda))
    assert runtime.LAUNCHES["flash_attention"] == before + cfg.n_layers
    torch.testing.assert_close(full.cpu(), host(toks), atol=1e-4, rtol=1e-4)
    logits, pc = card.prefill(toks[:, :128].to(cuda))
    torch.testing.assert_close(logits, full[:, 127], atol=1e-4, rtol=1e-4)
    cache = init_cache(cfg, 2, 200, torch.float32, device=cuda)
    cache["k"][:, :, :, :128] = pc["k"]
    cache["v"][:, :, :, :128] = pc["v"]
    cache["k_local"].copy_(pc["k_local"])
    cache["v_local"].copy_(pc["v_local"])
    for pos in range(128, 200):
        logits, cache = card.decode_step(cache, toks[:, pos].to(cuda), pos)
        torch.testing.assert_close(logits, full[:, pos], atol=1e-4,
                                   rtol=1e-4)


def test_train_step_on_card_matches_cpu(cuda):
    """gemma2-9b's smoke config at head_dim 64 (the kernels' smallest),
    float32: one train step of 2 microbatches with remat on the card,
    through kernel 10's forward and backward (launched 2 x layers x
    microbatches and layers x microbatches times), against the same step
    on the CPU through ``attention_ref``'s autograd; the same step twice on
    the card is bit-equal.  The serving model's outputs carry no autograd
    record."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core import tree as ttree
    from repro_torch.launch.steps import build_lm_train_step
    from repro_torch.train import optimizer as opt
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("gemma2-9b").smoke_config(),
                              head_dim=64, sliding_window=16)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 65)))
    t, l = toks[:, :-1], toks[:, 1:]
    step = build_lm_train_step(cfg, n_microbatches=2)
    want_p, want_s, want_l = step(params, opt.init(params), t, l)
    card = ttree.tree_map(lambda x: x.to(cuda), params)
    runs = []
    for _ in range(2):
        before = dict(runtime.LAUNCHES)
        runs.append(step(card, opt.init(card), t.to(cuda), l.to(cuda)))
        torch.cuda.synchronize()
        assert runtime.LAUNCHES["flash_attention"] - \
            before["flash_attention"] == 2 * cfg.n_layers * 2
        assert runtime.LAUNCHES["flash_attention_bwd"] - \
            before["flash_attention_bwd"] == cfg.n_layers * 2
    got_p, got_s, got_l = runs[0]
    torch.testing.assert_close(got_l.cpu(), want_l, atol=1e-5, rtol=1e-5)
    for a, b in zip(ttree.tree_leaves((got_p, got_s)),
                    ttree.tree_leaves((want_p, want_s))):
        torch.testing.assert_close(a.cpu(), b, atol=2e-5, rtol=1e-4)
    for a, b in zip(ttree.tree_leaves(runs[0]), ttree.tree_leaves(runs[1])):
        assert torch.equal(a, b)
    model = TransformerLM(cfg, card)
    out = model(t.to(cuda))
    logits, cache = model.prefill(t.to(cuda))
    lg, cache = model.decode_step(cache, l[:, -1].to(cuda), 0)
    assert all(x.grad_fn is None and not x.requires_grad
               for x in [out, logits, lg, *cache.values()])


def test_moe_on_card_matches_cpu(cuda):
    """A two-layer qwen3-style MoE model (head_dim 64, QK norm, 16 experts
    top-4, float32) on the card against the same model on the CPU: the
    FFN alone at a capacity that drops, ungrouped and in 2 groups, with
    the same kept assignments; forward, and decode after prefill against
    forward on the card."""
    import dataclasses

    from repro_torch.models import transformer as tfm
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LMConfig(name="moe-card", n_layers=2, d_model=256, n_heads=4,
                   n_kv_heads=2, head_dim=64, d_ff=128, vocab_size=1024,
                   n_experts=16, top_k=4, qk_norm=True,
                   tie_embeddings=False, dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    x = torch.randn((512, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    lw = {k: params["layers"][k][0] for k in ("router", "w_gate", "w_up",
                                              "w_down")}
    lw_card = {k: v.to(cuda) for k, v in lw.items()}
    for groups in (1, 2):
        c = dataclasses.replace(cfg, capacity_factor=1.0,
                                dispatch_groups=groups)
        xg = x.reshape(groups, -1, cfg.d_model)
        host, card = (tfm.moe_route(xg, lw["router"], c),
                      tfm.moe_route(xg.to(cuda), lw_card["router"], c))
        assert not bool(host.keep.all())
        assert torch.equal(card.keep.cpu(), host.keep)
        assert torch.equal(card.slot.cpu(), host.slot)
        torch.testing.assert_close(tfm.moe_ffn(x.to(cuda), lw_card,
                                               c).cpu(),
                                   tfm.moe_ffn(x, lw, c), atol=1e-4,
                                   rtol=1e-4)
    on_card = {k: ({n: t.to(cuda) for n, t in v.items()}
                   if isinstance(v, dict) else v.to(cuda))
               for k, v in params.items()}
    host, card = TransformerLM(cfg, params), TransformerLM(cfg, on_card)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 96)))
    full = card(toks.to(cuda))
    torch.testing.assert_close(full.cpu(), host(toks), atol=1e-4, rtol=1e-4)
    # decode drops nothing (C >= 8 > B); forward over 2 x 96 tokens at
    # capacity E / K = 4 keeps every assignment too
    assert tfm.moe_capacity(2 * 96, cfg) < 2 * 96
    cfg_all = dataclasses.replace(cfg, capacity_factor=4.0)
    card_all = TransformerLM(cfg_all, on_card)
    full = card_all(toks.to(cuda))
    logits, pc = card_all.prefill(toks[:, :64].to(cuda))
    torch.testing.assert_close(logits, full[:, 63], atol=1e-4, rtol=1e-4)
    cache = init_cache(cfg_all, 2, 96, torch.float32, device=cuda)
    cache["k"][:, :, :, :64] = pc["k"]
    cache["v"][:, :, :, :64] = pc["v"]
    for pos in range(64, 96):
        logits, cache = card_all.decode_step(cache, toks[:, pos].to(cuda),
                                             pos)
        torch.testing.assert_close(logits, full[:, pos], atol=1e-4,
                                   rtol=1e-4)


def test_mind_on_card_matches_cpu(cuda):
    """Histories out of a graph on the card bit-equal to the same graph's
    on the CPU; MIND's interests, serve and retrieval scores and loss on
    the card within 1e-5 of the CPU's."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.recsys import mind
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(4)
    V = 3000
    src = np.concatenate([np.zeros(900, np.int64), rng.integers(0, V, 20000)])
    dst = rng.integers(0, V, len(src))
    g_host = from_edges_host(V, src, dst, hashing=True, device="cpu")
    g_card = from_edges_host(V, src, dst, hashing=True, device=cuda)
    users = torch.from_numpy(rng.integers(0, V, 700))
    h_host, m_host = mind.history_from_slab(g_host, users, hist_len=50)
    h_card, m_card = mind.history_from_slab(g_card, users.to(cuda),
                                            hist_len=50)
    assert torch.equal(h_card.cpu(), h_host)
    assert torch.equal(m_card.cpu(), m_host)
    assert int(m_host.sum(dim=1).max()) == 50
    base = dataclasses.replace(get_arch("mind").full_config(), n_items=4096)
    params = mind.init_params(base, torch.Generator().manual_seed(0))
    p_card = {k: v.to(cuda) for k, v in params.items()}
    cand = torch.from_numpy(rng.integers(0, base.n_items, 300))
    target = torch.from_numpy(rng.integers(0, base.n_items, 700))
    for routing in ("f32", "bf16"):
        cfg = dataclasses.replace(base, routing_dtype=routing, neg_groups=2)
        tol = dict(atol=1e-5, rtol=1e-4 if routing == "f32" else 1e-2)
        args = (h_host, m_host)
        cargs = (h_card, m_card)
        torch.testing.assert_close(
            mind.serve_scores(p_card, *cargs, cand.to(cuda), cfg).cpu(),
            mind.serve_scores(params, *args, cand, cfg), **tol)
        emb = params["item_embed"][:1000]
        torch.testing.assert_close(
            mind.retrieval_scores(p_card, *cargs, emb.to(cuda), cfg).cpu(),
            mind.retrieval_scores(params, *args, emb, cfg), **tol)
        torch.testing.assert_close(
            mind.train_loss(p_card, *cargs, target.to(cuda), cfg).cpu(),
            mind.train_loss(params, *args, target, cfg), **tol)


# ----------------------------------------------------------------------------
# durability: checkpoint and crash recovery onto the card
# ----------------------------------------------------------------------------

DUR_V = 96
DUR_SITES = ("apply.admitted", "store.capacity_grow", "apply.post_wal",
             "apply.pre_close", "apply.post_close")


def _dur_store(device):
    from repro_torch.stream import GraphStore, MaintenancePolicy
    rng = np.random.default_rng(3)
    src = rng.integers(0, DUR_V, 400).astype(np.uint32)
    dst = rng.integers(0, DUR_V, 400).astype(np.uint32)
    return GraphStore.from_edges(
        DUR_V, src, dst, device=device,
        maintenance=MaintenancePolicy(tombstone_ratio=0.05))


def _dur_stream(n):
    """Random inserts, and deletes of seed edges, so the policy compacts
    every second epoch."""
    rng = np.random.default_rng(23)
    s0 = np.random.default_rng(3).integers(0, DUR_V, (2, 400)) \
        .astype(np.uint32)
    return [(rng.integers(0, DUR_V, 60).astype(np.uint32),
             rng.integers(0, DUR_V, 60).astype(np.uint32), None,
             s0[0, 12 * t:12 * t + 12], s0[1, 12 * t:12 * t + 12])
            for t in range(n)]


def _assert_views_equal(a, b):
    assert a.version == b.version
    for name in b.views:
        for f in FIELDS:
            x, y = getattr(a.views[name], f), getattr(b.views[name], f)
            assert (x is None and y is None) or (
                x.shape == y.shape and torch.equal(x.cpu(), y.cpu())), \
                (name, f)


def test_checkpoint_save_restore_on_card(cuda, tmp_path):
    from repro_torch.algorithms import wcc_stream_property
    from repro_torch.stream import GraphStore, PropertyRegistry
    store = _dur_store(cuda)
    registry = PropertyRegistry(store)
    registry.register(wcc_stream_property())
    for b in _dur_stream(3):
        store.apply(*b)
    store.save(tmp_path, registry=registry)
    got, reg2 = GraphStore.restore(tmp_path, specs=[wcc_stream_property()])
    assert got.device.type == "cuda"
    assert all(g.keys.is_cuda for g in got.views.values())
    _assert_views_equal(got, store)
    assert torch.equal(reg2.read("wcc"), registry.read("wcc"))
    # and the same checkpoint restores on the CPU, leaf for leaf
    host, _ = GraphStore.restore(tmp_path, specs=[wcc_stream_property()],
                                 device="cpu")
    _assert_views_equal(host, store)


@pytest.mark.parametrize("site", DUR_SITES)
def test_recover_onto_card_matches_twin(cuda, site, tmp_path):
    from repro_torch import resilience as rz
    from repro_torch.resilience import faults
    from repro_torch.stream import MaintenancePolicy
    batches = _dur_stream(8)
    twin = _dur_store(cuda)
    vers = []
    for b in batches:
        twin.apply(*b)
        vers.append(twin.version)
    assert twin.maintenance_count >= 2
    store = _dur_store(cuda).attach_wal(rz.WriteAheadLog(tmp_path / "wal"))
    with pytest.raises(rz.InjectedCrash):
        for t, b in enumerate(batches):
            if t == 2:
                store.save(tmp_path / "ck")
            if t == 5:
                with faults.inject(rz.FaultSpec(site, at=1)):
                    store.apply(*b)
            else:
                store.apply(*b)
    store.wal.close()
    rec, _, report = rz.recover(
        tmp_path / "ck", tmp_path / "wal",
        maintenance=MaintenancePolicy(tombstone_ratio=0.05))
    assert rec.device.type == "cuda" and not report.anomalies
    for b in batches[vers.index(rec.version) + 1:]:
        rec.apply(*b)
    _assert_views_equal(rec, twin)
    assert rz.audit_store(rec).ok


# ----------------------------------------------------------------------------
# the sharded plane on the card: the same store on CPU tensors is the oracle
# ----------------------------------------------------------------------------

SHARD_V, SHARDS = 2003, 4


def _sharded_store(device, *, weighted=False):
    from repro_torch.stream import MaintenancePolicy, ShardedGraphStore
    rng = np.random.default_rng(31)
    src = rng.integers(0, SHARD_V, 12000).astype(np.uint32)
    dst = (rng.zipf(1.5, 12000) % SHARD_V).astype(np.uint32)
    src[:600] = 6                       # a hub: a long chain on shard 2
    w = rng.uniform(0.5, 2.0, 12000).astype(np.float32) if weighted \
        else None
    return ShardedGraphStore.from_edges(
        SHARD_V, SHARDS, src, dst, w,
        maintenance=MaintenancePolicy(tombstone_ratio=0.05), device=device)


def _shard_stream(n, seed=32, *, weighted=False):
    rng = np.random.default_rng(seed)
    out = []
    for e in range(n):
        k = 2000 if e == 1 else 600     # epoch 1 grows the pools
        s = rng.integers(0, SHARD_V, k).astype(np.uint32)
        if e == 1:
            s[:1500] = 6
        d = rng.integers(0, SHARD_V, k).astype(np.uint32)
        w = rng.uniform(0.5, 2.0, k).astype(np.float32) if weighted \
            else None
        ds = rng.integers(0, SHARD_V, 400).astype(np.uint32)
        dd = (rng.zipf(1.5, 400) % SHARD_V).astype(np.uint32)
        out.append((s, d, w, ds, dd))
    return out


def _assert_sharded_views_equal(a, b):
    assert a.version == b.version
    for name in b.views:
        ga, gb = a.views[name].graphs, b.views[name].graphs
        for f in FIELDS:
            x, y = getattr(ga, f), getattr(gb, f)
            assert (x is None and y is None) or (
                x.shape == y.shape and torch.equal(x.cpu(), y.cpu())), \
                (name, f)


@pytest.mark.parametrize("weighted", [False, True])
def test_sharded_store_on_card_matches_cpu(cuda, weighted):
    from repro_torch.distributed import sharded_graph as sgm
    card = _sharded_store(cuda, weighted=weighted)
    host = _sharded_store("cpu", weighted=weighted)
    before = dict(runtime.LAUNCHES)
    for b in _shard_stream(4, weighted=weighted):
        bc, bh = card.apply(*b), host.apply(*b)
        assert (bc.n_inserted, bc.n_deleted) == (bh.n_inserted,
                                                 bh.n_deleted)
        _assert_sharded_views_equal(card, host)
    assert card.maintenance_count == host.maintenance_count >= 1
    for name in ("slab_probe", "slab_commit", "slab_live",
                 "slab_chain_rank"):
        assert runtime.LAUNCHES[name] > before[name], name
    if not weighted:
        for fn, view in ((sgm.wcc_sharded, "symmetric"),):
            got, _ = fn(card.views[view], rows=card.sweep_rows(view))
            want, _ = fn(host.views[view], rows=host.sweep_rows(view))
            assert torch.equal(got.cpu(), want)
        got, _ = sgm.bfs_sharded(card.transpose, src=0)
        want, _ = sgm.bfs_sharded(host.transpose, src=0)
        assert torch.equal(got.cpu(), want)
    pr, _ = sgm.pagerank_sharded(card.transpose, card.out_degree)
    pr_h, _ = sgm.pagerank_sharded(host.transpose, host.out_degree)
    assert torch.allclose(pr.cpu(), pr_h, atol=2e-5, rtol=0)
    tri = sgm.triangles_sharded(card.symmetric)
    assert tri.is_cuda and int(tri) == int(sgm.triangles_sharded(
        host.symmetric))
    q = np.random.default_rng(3).integers(0, SHARD_V, (4096, 2))
    assert np.array_equal(card.query(q[:, 0], q[:, 1]),
                          host.query(q[:, 0], q[:, 1]))
    nc = card.neighbors([6, 0, 7, 2002], out_capacity=8192)
    nh = host.neighbors([6, 0, 7, 2002], out_capacity=8192)
    assert int(nc.size) == int(nh.size)
    for a, b in zip(nc, nh):
        assert torch.equal(a.cpu(), b)
    from repro_torch.resilience import audit_store
    assert audit_store(card).ok


def test_kernel_summary_on_card(cuda):
    from repro_torch import obs
    from repro_torch.core.slab_graph import shard_view
    from repro_torch.kernels.slab_sweep import ops as sweep_ops
    store = _sharded_store(cuda)
    obs.reset()
    obs.enable()
    try:
        for b in _shard_stream(3):
            store.apply(*b)
        g = shard_view(store.transpose.graphs, 0)
        for _ in range(3):
            sweep_ops.sweep_vertices(g, torch.ones(SHARD_V, device=cuda),
                                     semiring="sum", n_keys=SHARD_V)
        summary = obs.kernel_summary()
    finally:
        obs.disable()
        obs.reset()
    upd = [k for k in summary.values() if k["op"] == "update_shards"]
    assert sum(k["calls"] for k in upd) == 3
    sweep = [k for k in summary.values() if k["op"] == "sweep_vertices"]
    assert len(sweep) == 1 and sweep[0]["calls"] == 3
    assert sweep[0]["steady_calls"] == 2 and sweep[0]["steady_s"] > 0
    assert sweep[0]["bytes"] > 0


def test_sharded_restore_and_recover_onto_card(cuda, tmp_path):
    from repro_torch import resilience as rz
    from repro_torch.resilience import faults
    from repro_torch.stream import (MaintenancePolicy, PropertyRegistry,
                                    ShardedGraphStore, sharded_wcc_property)
    batches = _shard_stream(6)
    twin = _sharded_store(cuda)
    vers = []
    for b in batches:
        twin.apply(*b)
        vers.append(twin.version)
    store = _sharded_store(cuda).attach_wal(rz.WriteAheadLog(
        tmp_path / "wal"))
    registry = PropertyRegistry(store)
    registry.register(sharded_wcc_property())
    with pytest.raises(rz.InjectedCrash):
        for t, b in enumerate(batches):
            if t == 2:
                store.save(tmp_path / "ck", registry=registry)
                got, reg2 = ShardedGraphStore.restore(
                    tmp_path / "ck", specs=[sharded_wcc_property()])
                assert got.device.type == "cuda"
                _assert_sharded_views_equal(got, store)
                assert torch.equal(reg2.read("wcc"), registry.read("wcc"))
            if t == 4:
                with faults.inject(rz.FaultSpec("apply.post_wal", at=1)):
                    store.apply(*b)
            else:
                store.apply(*b)
    store.wal.close()
    rec, _, report = rz.recover(
        tmp_path / "ck", tmp_path / "wal", store_cls=ShardedGraphStore,
        specs=[sharded_wcc_property()],
        maintenance=MaintenancePolicy(tombstone_ratio=0.05))
    assert rec.device.type == "cuda" and not report.anomalies
    for b in batches[vers.index(rec.version) + 1:]:
        rec.apply(*b)
    _assert_sharded_views_equal(rec, twin)
    assert rz.audit_store(rec).ok


# ----------------------------------------------------------------------------
# the sharded plane's multi-process rendering on the card
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("backend,world", [("gloo", 2), ("nccl", 1)])
def test_mesh_ranks_on_card_match_the_stacked_store(cuda, backend, world,
                                                    tmp_path):
    """Two gloo ranks sharing the card (NCCL refuses two ranks on one
    card) and one NCCL rank: every pool leaf after every epoch equals the
    stacked store's on the card, WCC, BFS and the triangle count bit for
    bit, PageRank within 2e-5; the ranks launch the kernels."""
    import _torch_mesh_ranks as M
    from repro_torch.distributed import sharded_graph as sgm
    from repro_torch.distributed.ranks import RankGroup
    from repro_torch.stream import MaintenancePolicy, ShardedGraphStore

    cfg = f"card{world}"
    V, S, _ = M.CONFIGS[cfg]
    src, dst, _ = M.boot_edges(cfg)
    stacked = ShardedGraphStore.from_edges(
        V, S, src, dst, maintenance=MaintenancePolicy(
            tombstone_ratio=M.RATIO), device=cuda)
    stacked.save(tmp_path / "boot_u")
    group = RankGroup(M.card_rank, S, (backend, cfg, str(tmp_path)),
                      deadline_s=300)
    try:
        group.wait()
    finally:
        errors = [r.get("error") for r in M.load_results(str(tmp_path), S)
                  if r.get("error")] if all(
            (tmp_path / f"rank{r}.pkl").is_file() for r in range(S)) else []
        assert not errors, "\n".join(errors)
    ranks = M.load_results(str(tmp_path), S)
    want = [M.store_leaves(stacked)]
    for kind, s, d, w, ds, dd in M.epochs(cfg):
        stacked.apply(s, d, w, ds, dd)
        want.append(M.store_leaves(stacked))
    assert stacked.maintenance_count >= 1
    for e, leaves in enumerate(want):
        for view, fields in leaves.items():
            for f, a in fields.items():
                if a is None:
                    continue
                got = np.concatenate([r["epochs"][e][view][f]
                                      for r in ranks])
                assert got.shape == a.shape and np.array_equal(got, a), \
                    (e, view, f)
    wcc, _ = sgm.wcc_sharded(stacked.symmetric)
    bfs, _ = sgm.bfs_sharded(stacked.transpose, src=0)
    pr, _ = sgm.pagerank_sharded(stacked.transpose, stacked.out_degree)
    tri = int(sgm.triangles_sharded(stacked.symmetric))
    for r in ranks:
        assert r["device"] == "cuda:0"
        assert np.array_equal(r["wcc"], wcc.cpu().numpy())
        assert np.array_equal(r["bfs"], bfs.cpu().numpy())
        assert np.abs(r["pagerank"] - pr.cpu().numpy()).max() <= 2e-5
        assert r["triangles"] == tri
        for name in ("slab_probe", "slab_commit", "slab_sweep", "slab_live",
                     "slab_chain_rank", "slab_count"):
            assert r["launches"][name] > 0, name


def test_mesh_wal_and_recovery_on_one_nccl_rank(cuda, tmp_path):
    """One NCCL rank with a WAL and audits every epoch: a kill after the
    WAL append in the second epoch, ``recover`` onto the card and
    ``place_on_mesh``, the last epoch: the pools equal the stacked store's
    uninterrupted run on the card, the WAL records (the replayed one
    included) equal its, every audit is clean."""
    import _torch_mesh_ranks as M
    from repro_torch import resilience as rz
    from repro_torch.distributed.ranks import RankGroup
    from repro_torch.stream import MaintenancePolicy, ShardedGraphStore

    cfg = "card1"
    V, S, _ = M.CONFIGS[cfg]
    src, dst, _ = M.boot_edges(cfg)
    stacked = ShardedGraphStore.from_edges(
        V, S, src, dst, maintenance=MaintenancePolicy(
            tombstone_ratio=M.RATIO), device=cuda)
    stacked.save(tmp_path / "boot_u")
    group = RankGroup(M.card_durable_rank, S,
                      ("nccl", cfg, str(tmp_path)), deadline_s=300)
    try:
        group.wait()
    finally:
        errors = [r.get("error") for r in M.load_results(str(tmp_path), S)
                  if r.get("error")] if (tmp_path / "rank0.pkl").is_file() \
            else []
        assert not errors, "\n".join(errors)
    got = M.load_results(str(tmp_path), S)[0]
    stacked.attach_wal(rz.WriteAheadLog(tmp_path / "stacked_wal"))
    for kind, s, d, w, ds, dd in M.epochs(cfg):
        stacked.apply(s, d, w, ds, dd)
    stacked.wal.close()
    assert got["killed"] and got["replayed"] == 1
    assert got["device"] == "cuda:0" and got["version"] == stacked.version
    assert got["audits"] and all(a["ok"] for a in got["audits"])
    leaves = M.store_leaves(stacked)
    for view, fields in leaves.items():
        for f, a in fields.items():
            if a is not None:
                assert np.array_equal(got["leaves"][view][f], a), (view, f)
    mine, _ = rz.read_wal(tmp_path / "wal")
    want, _ = rz.read_wal(tmp_path / "stacked_wal")
    assert len(mine) == len(want) == 3
    for a, b in zip(mine, want):
        assert a.version == b.version
        for f in ("ins_src", "ins_dst", "del_src", "del_dst"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_slab_contrib_sums_on_card_matches_plain(cuda, graph):
    """Kernel 4's op on the card (its own kernel, one launch, no launch of
    kernel 3) against its plain version on the same packed pool, within
    1e-6 of the largest row total (the float sum's rounding)."""
    from repro_torch.core.worklist import pool_edges
    from repro_torch.kernels.slab_pagerank import (slab_contrib_sums,
                                                   slab_contrib_sums_ref)
    _, _, _, g = graph
    contrib = torch.rand(g.n_vertices, device=cuda)
    before = dict(runtime.LAUNCHES)
    got = slab_contrib_sums(g.keys, pool_edges(g).valid, contrib)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["slab_sweep"] == before["slab_sweep"]
    assert runtime.LAUNCHES["slab_contrib_sums"] == \
        before["slab_contrib_sums"] + 1
    owner = torch.where(pool_edges(g).valid.any(dim=1), 0, -1).to(
        torch.int32)
    want = slab_contrib_sums_ref(g.keys, owner, contrib,
                                 n_vertices=g.n_vertices)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-6 * float(want.abs().max()) + 1e-30)


def _rotated_rows(keys: torch.Tensor, seed: int) -> torch.Tensor:
    """A copy of ``keys`` with each row's lanes rotated right by a seeded
    amount in [1, its EMPTY lanes]: a packed row's EMPTY lanes come first,
    and its keys follow them."""
    from repro_torch.core.hashing import EMPTY_KEY
    S, W = keys.shape
    n_empty = (keys == EMPTY_KEY).sum(dim=1)
    gen = torch.Generator(device=keys.device).manual_seed(seed)
    u = torch.rand(S, generator=gen, device=keys.device)
    shift = 1 + (u * n_empty).long().clamp(max=W - 1)
    lane = torch.arange(W, device=keys.device)
    return torch.gather(keys, 1, (lane[None, :] - shift[:, None]) % W)


def test_slab_contrib_sums_on_card_matches_plain_on_unpacked_rows(cuda,
                                                                 graph):
    """Kernel 4 reads every lane: on a copy of the pool whose rows hold
    their keys after EMPTY lanes (and a TOMBSTONE, a key >= V and an
    unowned row holding keys), the kernel equals its plain version, and
    kernel 3, which stops at a row's first EMPTY lane, does not."""
    from repro_torch.core.hashing import TOMBSTONE_KEY
    from repro_torch.kernels.slab_pagerank import (slab_contrib_sums_cuda,
                                                   slab_contrib_sums_ref)
    _, _, _, g = graph
    V = g.n_vertices
    keys = _rotated_rows(g.keys, seed=3)
    owner = g.slab_vertex.clone()
    rows = torch.nonzero(owner >= 0).flatten()
    keys[rows[0], 5] = TOMBSTONE_KEY
    keys[rows[1], 9] = V + 3
    owner[rows[2]] = -1
    contrib = torch.rand(V, device=cuda)
    before = dict(runtime.LAUNCHES)
    got = slab_contrib_sums_cuda(keys, owner, contrib, n_vertices=V)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["slab_contrib_sums"] == \
        before["slab_contrib_sums"] + 1
    want = slab_contrib_sums_ref(keys, owner, contrib, n_vertices=V)
    atol = 1e-6 * float(want.abs().max()) + 1e-30
    torch.testing.assert_close(got, want, rtol=0, atol=atol)
    assert float(got[rows[2]]) == 0.0
    packed_only = slab_sweep(keys, owner, contrib, semiring="sum",
                             n_vertices=V)
    assert float((packed_only - want).abs().max()) > atol


def test_pagerank_ref_on_card_matches_sweep(cuda, graph):
    """PageRank with the reference's default ``contrib_impl="ref"`` (kernel
    4, one launch an iteration, no kernel 3) against ``"sweep"`` (kernel
    3) on the card: the same iterations, the vectors within 2e-5."""
    from repro_torch.algorithms import pagerank
    _, _, _, g = graph
    gt = transpose_host(g, device=cuda)
    before = dict(runtime.LAUNCHES)
    pr_ref, it_ref = pagerank(gt, g.degree, contrib_impl="ref")
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["slab_contrib_sums"] == \
        before["slab_contrib_sums"] + it_ref
    assert runtime.LAUNCHES["slab_sweep"] == before["slab_sweep"]
    pr_sweep, it_sweep = pagerank(gt, g.degree, contrib_impl="sweep")
    assert it_ref == it_sweep
    assert float((pr_ref - pr_sweep).abs().max()) <= 2e-5


@pytest.fixture
def no_tf32():
    """float32 products without TF32 for one test, the setting restored
    after it."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = was


@pytest.mark.parametrize("arch", ["mace", "nequip", "pna", "equiformer-v2"])
def test_gnn_step_on_card_matches_cpu(cuda, no_tf32, arch):
    """A GNN smoke config's train step on the card against the same step on
    the CPU, float32 without TF32: the loss, the parameters and the AdamW
    moments within 1e-5 / 1e-4 (the card's segment sums add with
    atomics, in another order)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import tree as ttree
    from repro_torch.launch import steps as S
    from repro_torch.models.gnn import common as gnn
    from repro_torch.train import optimizer as opt
    module, style = S._GNN[arch]
    cfg = get_arch(arch).smoke_config()
    gen = torch.Generator().manual_seed(0)
    params = module.init_params(cfg, gen)
    if style == "geometric":
        batch = gnn.random_geometric_batch(gen, 48, 200, n_graphs=4,
                                           n_species=cfg.n_species)
        targets = torch.randn((4,), generator=gen)
    else:
        batch = gnn.random_feature_graph(gen, 60, 240, cfg.d_in)
        targets = torch.randint(0, cfg.n_classes, (60,), generator=gen)
    step = S.build_gnn_train_step(module, cfg, style)
    want = step(params, opt.init(params), batch, targets)
    card = ttree.tree_map(lambda x: x.to(cuda), params)
    got = step(card, opt.init(card), batch.to(cuda), targets.to(cuda))
    for a, b in zip(ttree.tree_leaves(got), ttree.tree_leaves(want)):
        assert a.is_cuda
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=1e-4)
