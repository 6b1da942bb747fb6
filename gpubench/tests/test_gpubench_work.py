"""Needed bytes of each operation family on small hand-built pools: what
the call needs, whatever spare capacity the pool holds."""
import pytest
import torch

from gpubench.harness import work
from gpubench.tests._tiny import REPO

EMPTY, TOMB = -2, -3
FAMS = work.families(REPO)


def pool(rows, spare=0):
    """(S, 128) keys: row r holds keys 0 .. rows[r]-1, then (in a row not
    full) a tombstone, then EMPTY lanes; ``spare`` EMPTY rows after them."""
    keys = torch.full((len(rows) + spare, 128), EMPTY, dtype=torch.int32)
    for r, live in enumerate(rows):
        keys[r, :live] = torch.arange(live, dtype=torch.int32)
        if live < 128:
            keys[r, live] = TOMB
    return keys


def owners(n_rows, spare):
    return torch.cat([torch.arange(n_rows, dtype=torch.int32),
                      torch.full((spare,), -1, dtype=torch.int32)])


def count(fam, fn, *args, result=None, **kw):
    return int(getattr(FAMS[fam], fn)(result, *args, **kw))


@pytest.mark.parametrize("spare", [0, 5, 1000])
def test_sweep_counts_live_lanes_and_rows(spare):
    keys, owner = pool([3, 0, 7], spare), owners(3, spare)
    vals = torch.zeros(16)
    got = count("sweep", "sweep_bytes", keys, owner, vals, semiring="sum",
                n_vertices=16)
    # 10 live lanes, 7 distinct keys (0..6) gathered once each, 3 rows
    assert got == 4 * 10 + 4 * 7 + 4 * 3


@pytest.mark.parametrize("spare", [0, 64])
def test_sweep_gathers_only_frontier_keys(spare):
    """With a frontier, every live lane reads its key and each distinct
    key its flag, but a value is gathered only where the flag is set."""
    keys, owner = pool([3, 0, 7], spare), owners(3, spare)
    vals = torch.zeros(16, dtype=torch.int32)
    front = torch.zeros(16, dtype=torch.bool)
    front[[1, 5]] = True              # key 1: 2 lanes, key 5: 1 lane
    got = count("sweep", "sweep_bytes", keys, owner, vals, None, front,
                semiring="min", n_vertices=16)
    assert got == 4 * 10 + 7 + 2 * 4 + 4 * 3
    target = torch.zeros(keys.shape[0], dtype=torch.int32)
    got = count("sweep", "sweep_bytes", keys, owner, vals, None, front,
                target, semiring="arg_min_plus", n_vertices=16)
    assert got == 4 * 10 + 7 + 2 * 4 + 8 * 3


@pytest.mark.parametrize("spare", [0, 64])
def test_contrib_sums(spare):
    keys, owner = pool([5, 2], spare), owners(2, spare)
    got = count("contrib_sums", "contrib_bytes", keys, owner,
                torch.zeros(8), n_vertices=8)
    assert got == 4 * 7 + 4 * 5 + 4 * 2


def chained(spare):
    """Rows 0 -> 3 -> 4 (one chain), row 1 alone, row 2 -> 5."""
    keys = pool([4, 9, 1, 128, 6, 3], spare)
    keys[3] = torch.arange(100, 228, dtype=torch.int32)
    keys[4, :6] = torch.arange(300, 306, dtype=torch.int32)
    nxt = torch.full((keys.shape[0],), -1, dtype=torch.int32)
    nxt[0], nxt[3], nxt[2] = 3, 4, 5
    return keys, nxt


@pytest.mark.parametrize("spare", [0, 64])
def test_probe_walks_to_the_hit_or_the_chain_end(spare):
    keys, nxt = chained(spare)
    start = torch.tensor([0, 0, 0, 1, 2, -1], dtype=torch.int32)
    dst = torch.tensor([2, 150, 999, 3, 0, 7], dtype=torch.int32)
    found = torch.tensor([1, 1, 0, 1, 1, 0], dtype=torch.uint8)
    slab = torch.tensor([0, 3, -1, 1, 2, -1], dtype=torch.int32)
    got = count("probe", "probe_bytes", keys, nxt, start, dst,
                result=(found, slab, slab))
    # chain 0 to its end once (the miss walks furthest), rows 1 and 2
    walked_lanes = (4 + 128 + 6) + 9 + 1
    walked_rows = 3 + 1 + 1
    assert got == 17 * 6 + 4 * walked_lanes + 4 * walked_rows


def test_probe_count_matches_a_plain_walk():
    """On a random pool of chains, the pointer-jumping count equals a walk
    row by row, each chain counted to the furthest row any query
    reaches."""
    gen = torch.Generator().manual_seed(5)
    S = 300
    keys = torch.randint(-3, 50, (S, 128), generator=gen, dtype=torch.int32)
    perm = torch.randperm(S, generator=gen)
    nxt = torch.full((S,), -1, dtype=torch.int32)
    heads = []
    at = 0
    while at < S:
        n = int(torch.randint(1, 12, (1,), generator=gen))
        chain = perm[at:at + n]
        heads.append(int(chain[0]))
        nxt[chain[:-1]] = chain[1:].int()
        at += n
    B = 200
    start = torch.tensor(heads)[torch.randint(0, len(heads), (B,),
                                              generator=gen)].int()
    dst = torch.randint(0, 60, (B,), generator=gen, dtype=torch.int32)
    found = torch.zeros(B, dtype=torch.uint8)
    slab = torch.full((B,), -1, dtype=torch.int32)
    far = {}
    for q in range(B):
        cur, cost = int(start[q]), 0
        while cur >= 0:
            cost += 4 * int((keys[cur] >= 0).sum()) + 4
            if bool((keys[cur] == dst[q]).any()):
                found[q], slab[q] = 1, cur
                break
            cur = int(nxt[cur])
        far[int(start[q])] = max(far.get(int(start[q]), 0), cost)
    want = 17 * B + sum(far.values())
    assert count("probe", "probe_bytes", keys, nxt, start, dst,
                 result=(found, slab, slab)) == want


@pytest.mark.parametrize("spare", [0, 64])
def test_commit_counts_planned_writes(spare):
    keys = pool([4, 9], spare)
    degree = torch.zeros(10, dtype=torch.int32)
    e_slab = torch.tensor([0, 1, -1, 99999], dtype=torch.int32)
    e_lane = torch.zeros(4, dtype=torch.int32)
    deg_idx = torch.tensor([3, -1, 4, 4], dtype=torch.int32)
    got = count("commit", "commit_bytes", keys, degree, None, e_slab, e_lane,
                e_lane, deg_idx, e_lane)
    assert got == 20 * 4 + 4 * 2 + 8 * 2      # vertices 3 and 4 once


@pytest.mark.parametrize("spare", [0, 64])
def test_compaction_passes(spare):
    keys, owner = pool([4, 9], spare), owners(2, spare)
    S = keys.shape[0]
    assert count("compaction", "live_bytes", keys, owner) == 8 * 13 + 8 * 2
    nxt = torch.full((S,), -1, dtype=torch.int32)
    assert count("compaction", "rank_bytes", nxt, nxt, 2) == 20 * S + 8


def test_every_family_names_kernels_and_hooks():
    assert set(FAMS) == {"probe", "commit", "sweep", "contrib_sums",
                         "compaction"}
    for mod in FAMS.values():
        assert mod.KERNELS and mod.HOOKS
        for fn in mod.HOOKS.values():
            assert callable(getattr(mod, fn))
    assert work.kernel_family(
        "void (anonymous namespace)::sweep_kernel<0, float>(...)",
        FAMS) == "sweep"
    assert work.kernel_family("long_chain_kernel(int const*)", FAMS) == \
        "compaction"
    assert work.kernel_family("void at::elementwise_kernel<128>", FAMS) \
        is None


def test_counter_hooks_counts_after_the_call_and_restores():
    import repro_torch.kernels.slab_update.ops as ops
    original = ops.slab_probe
    c = work.Counter({"probe": FAMS["probe"]})
    c.install()
    try:
        assert ops.slab_probe is not original
        keys = pool([2])
        found, _, _ = ops.slab_probe(
            keys, torch.full((1,), -1, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32),
            torch.tensor([1, 7], dtype=torch.int32))
    finally:
        c.uninstall()
    assert ops.slab_probe is original
    assert found.tolist() == [1, 0]
    # a hit in the head row and a miss at the end of the same one-row
    # chain: the row counts once
    assert c.totals()["probe"] == 17 * 2 + 4 * 2 + 4
