"""The generators and the round stream: deterministic per seed, GAP's
relabelling and symmetry, and the pool of edges put in kept exactly at
O(batch) cost on the host."""
from collections import Counter

import pytest
import torch

from gpubench.harness import graphs
from gpubench.harness.stream import EdgeStream, distinct_draws

GRAPH = {"generator": "rmat", "scale": 10, "edge_factor": 16,
         "a": 0.57, "b": 0.19, "c": 0.19, "permute": True,
         "symmetric": True}
URAND = {"generator": "uniform", "scale": 10, "edge_factor": 16,
         "permute": False, "symmetric": True}
MIX = {"batch": 512, "delete_share": 0.5, "member_pairs": 64,
       "member_from_pool_share": 0.5}


def rounds(seed, n=5, graph=GRAPH):
    init, perm = graphs.initial_edges(torch.Generator().manual_seed(seed),
                                      graph)
    s = EdgeStream(torch.Generator().manual_seed(seed + 1), graph, MIX, init,
                   perm)
    s.prepare(n - 1)                  # all but the last drawn in one go
    return init, [s.next_round() for _ in range(n)], s


@pytest.mark.parametrize("graph", [GRAPH, URAND], ids=["kron", "urand"])
def test_deterministic_per_seed(graph):
    a_init, a, _ = rounds(2 ** 31 + 5, graph=graph)
    b_init, b, _ = rounds(2 ** 31 + 5, graph=graph)
    c_init, _, _ = rounds(2 ** 31 + 6, graph=graph)
    assert torch.equal(a_init, b_init)
    assert not torch.equal(a_init, c_init)
    for x, y in zip(a, b):
        for f in ("deletes", "inserts", "member"):
            assert torch.equal(getattr(x, f), getattr(y, f))


@pytest.mark.parametrize("graph", [GRAPH, URAND], ids=["kron", "urand"])
def test_initial_edges_are_symmetric_distinct_and_loop_free(graph):
    init, _, _ = rounds(1, n=0, graph=graph)
    V = 1 << graph["scale"]
    assert torch.equal(init, torch.unique(init))
    assert not bool((init // V == init % V).any())
    assert torch.equal(torch.sort(graphs.reverse(init, V)).values, init)
    assert init.numel() > 0.9 * 16 * V


def test_kron_ids_are_permuted():
    """GAP relabels a Kronecker graph: the top hub is not vertex 0, and
    the degree ranking does not follow the ids."""
    V = 1 << 12
    gen = torch.Generator().manual_seed(3)
    raw = graphs.draw(gen, {**GRAPH, "scale": 12}, 16 * V)
    init, perm = graphs.initial_edges(torch.Generator().manual_seed(3),
                                      {**GRAPH, "scale": 12})
    assert torch.equal(torch.sort(perm).values, torch.arange(V))
    deg = torch.bincount(init // V, minlength=V)
    assert int(deg.argmax()) != 0
    assert int(deg[:V // 16].sum()) < 0.25 * int(deg.sum())
    # the same draws, relabelled
    assert torch.bincount(raw // V, minlength=V)[0] > \
        torch.bincount(raw // V, minlength=V)[V // 2:].max()


def test_rmat_is_skewed_and_uniform_is_not():
    V = 1 << 12
    gen = torch.Generator().manual_seed(3)
    k = graphs.draw(gen, {**GRAPH, "scale": 12}, 16 * V)
    u = graphs.draw(gen, {**URAND, "scale": 12}, 16 * V)
    assert torch.bincount(k // V, minlength=V).max() > \
        10 * torch.bincount(u // V, minlength=V).max()


def test_distinct_draws():
    gen = torch.Generator().manual_seed(9)
    d = distinct_draws(gen, 1000, 990)
    assert d.numel() == 990 and torch.unique(d).numel() == 990
    assert int(d.min()) >= 0 and int(d.max()) < 1000


def test_bulk_holes_are_distinct_and_in_range():
    _, _, s = rounds(3, n=0)
    sizes = torch.tensor([1000, 5000, 70000])
    s.n_del = 990
    holes = s._holes(sizes)
    for r, n in enumerate(sizes.tolist()):
        assert torch.unique(holes[r]).numel() == 990
        assert int(holes[r].min()) >= 0 and int(holes[r].max()) < n


def test_pool_tracks_the_edges_put_in():
    init, rs, s = rounds(7, n=6)
    V = 1 << GRAPH["scale"]
    pool = Counter(init[init // V < init % V].tolist())
    for r in rs:
        assert r.deletes.numel() == MIX["batch"] // 2
        assert r.inserts.numel() == MIX["batch"] // 2
        half = r.deletes.numel() // 2
        # both directions of every edge drawn
        assert torch.equal(r.deletes[half:],
                           graphs.reverse(r.deletes[:half], V))
        assert torch.equal(r.inserts[half:],
                           graphs.reverse(r.inserts[:half], V))
        for k in r.deletes[:half].tolist():
            assert pool[k] > 0
            pool[k] -= 1
        pool.update(r.inserts[:half].tolist())
    assert Counter(s.pool[:s.n].tolist()) == +pool


def test_inserts_follow_the_permutation():
    """The stream's R-MAT draws are relabelled as the initial list was, so
    its hubs are the graph's hubs."""
    init, rs, _ = rounds(11, n=40)
    V = 1 << GRAPH["scale"]
    deg = torch.bincount(init // V, minlength=V)
    ins = torch.cat([r.inserts for r in rs])
    hits = torch.bincount(ins // V, minlength=V)
    top = torch.topk(deg, 8).indices
    assert hits[top].sum() > 8 * hits.float().mean() * 4


def test_graph_from_the_configuration_stream_from_the_seed():
    from gpubench.harness.cell import draw_initial
    graph = {**GRAPH, "graph_seed": 27491095}
    a_init, a_perm = draw_initial(graph, torch.device("cpu"))
    b_init, _ = draw_initial(graph, torch.device("cpu"))
    assert torch.equal(a_init, b_init)
    a = EdgeStream(torch.Generator().manual_seed(1), graph, MIX, a_init,
                   a_perm)
    b = EdgeStream(torch.Generator().manual_seed(2 ** 31 + 9), graph, MIX,
                   a_init, a_perm)
    ra, rb = a.next_round(), b.next_round()
    assert not torch.equal(ra.deletes, rb.deletes)
    assert not torch.equal(ra.inserts, rb.inserts)
