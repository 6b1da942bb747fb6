"""Port parity: where the GNNs' graphs come from, against the reference on
the CPU.

* ``edges_from_slab`` bit-equal to ``repro.models.gnn.common``'s on a bond
  graph updated through both packages' engines (the reference's
  ``examples/gnn_molecules.py`` loop: inserts every step, deletes every
  third), also with ``max_edges`` below the live edge count (the overflow
  the reference's scatter drops).
* The random builders' structure (they draw from a ``torch.Generator``,
  so their numbers are not JAX's): shapes and dtypes, each edge within its
  graph's partition with the reference's offsets (``jnp.repeat`` with
  ``total_repeat_length``), self-loops masked and kept, the same batch from
  the same seed.
* ``data/sampler.py`` bit-equal to ``repro.data.sampler`` for the same
  seed, with degree-0 vertices in the frontier, and over the port's
  ``csr_snapshot`` of a live graph.
* ``python -m repro_torch.launch.train --arch <gnn> --device cpu`` for
  the four GNNs: three steps and a checkpoint.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_pools_equal, ids, jids, to_port

from repro.core import batch as jbatch
from repro.core import slab_graph as jsg
from repro.core.worklist import csr_snapshot as jcsr
from repro.data import sampler as jsampler
from repro.models.gnn import common as jcommon
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.core import batch as tbatch
from repro_torch.core import slab_graph as tsg
from repro_torch.core.worklist import csr_snapshot
from repro_torch.data import sampler as tsampler
from repro_torch.launch import train as tlaunch
from repro_torch.models.gnn import common as tcommon


def _assert_edges_equal(got, want, what):
    for a, b, name in zip(got, want, ("senders", "receivers", "edge_mask")):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, (what, name)
        assert np.array_equal(a.numpy(), b), (what, name)


@pytest.mark.parametrize("max_edges", [512, 40])
def test_edges_from_slab_bit_equal_on_a_live_graph(max_edges):
    V = 64
    rng = np.random.default_rng(0)
    gj = jsg.empty(V, np.ones(V, np.int32), 256)
    gt = to_port(gj)
    live = []
    for it in range(9):
        ns = rng.integers(0, V, 24)
        nd = rng.integers(0, V, 24)
        gj = jsg.ensure_capacity(gj, 32)
        gt = tsg.ensure_capacity(gt, 32)
        gj, _ = jbatch.insert_edges(gj, jids(ns, 32), jids(nd, 32))
        gt, _ = tbatch.insert_edges(gt, ids(ns, 32), ids(nd, 32))
        if it % 3 == 2:
            gj, _ = jbatch.delete_edges(gj, jids(ns[:8], 16),
                                        jids(nd[:8], 16))
            gt, _ = tbatch.delete_edges(gt, ids(ns[:8], 16),
                                        ids(nd[:8], 16))
        assert_pools_equal(gt, gj, f"step {it}")
        got = tcommon.edges_from_slab(gt, max_edges=max_edges)
        want = jcommon.edges_from_slab(gj, max_edges=max_edges)
        _assert_edges_equal(got, want, f"step {it}")
        live.append(int(gt.n_edges))
        n = min(live[-1], max_edges)
        assert int(got[2].sum()) == n and bool(got[2][:n].all())
    # the small case overflows: live edges past max_edges are dropped
    assert (max(live) > max_edges) == (max_edges == 40)


def _offsets(n_groups, per, total):
    """The reference's ``jnp.repeat(..., total_repeat_length=total)``."""
    return np.asarray(jnp.repeat(jnp.arange(n_groups, dtype=jnp.int32), per,
                                 total_repeat_length=total))


@pytest.mark.parametrize("n_nodes,n_edges,n_graphs",
                         [(48, 200, 4), (50, 203, 4), (30, 64, 1)])
def test_random_geometric_batch_structure(n_nodes, n_edges, n_graphs):
    g = torch.Generator().manual_seed(3)
    b = tcommon.random_geometric_batch(g, n_nodes, n_edges, n_species=7,
                                       n_graphs=n_graphs)
    again = tcommon.random_geometric_batch(torch.Generator().manual_seed(3),
                                           n_nodes, n_edges, n_species=7,
                                           n_graphs=n_graphs)
    assert b.n_nodes == n_nodes and b.n_edges == n_edges
    assert b.n_graphs == n_graphs and b.node_feat is None
    assert b.positions.shape == (n_nodes, 3)
    assert b.positions.dtype == torch.float32
    side = n_nodes ** (1 / 3) * 2.0
    assert float(b.positions.min()) >= 0 and float(b.positions.max()) < side
    for t in (b.species, b.senders, b.receivers, b.graph_ids):
        assert t.dtype == torch.int32
    assert b.edge_mask.dtype == torch.bool and bool(b.node_mask.all())
    assert 0 <= int(b.species.min()) and int(b.species.max()) < 7
    per = n_nodes // n_graphs
    assert np.array_equal(b.graph_ids.numpy(),
                          _offsets(n_graphs, per, n_nodes))
    off = _offsets(n_graphs, n_edges // n_graphs, n_edges) * per
    for ends in (b.senders.numpy(), b.receivers.numpy()):
        local = ends - off
        assert local.min() >= 0 and local.max() < per
    assert np.array_equal(b.edge_mask.numpy(),
                          b.senders.numpy() != b.receivers.numpy())
    assert not bool(b.edge_mask.all())          # self-loops kept, masked
    for f in ("positions", "species", "senders", "receivers"):
        assert torch.equal(getattr(b, f), getattr(again, f))


def test_random_feature_graph_structure_and_to():
    g = torch.Generator().manual_seed(4)
    b = tcommon.random_feature_graph(g, 60, 240, 24)
    assert b.node_feat.shape == (60, 24) and b.positions is None
    assert b.species is None and b.n_graphs == 1
    assert b.senders.dtype == b.receivers.dtype == torch.int32
    assert int(b.senders.max()) < 60 and int(b.receivers.min()) >= 0
    assert bool(b.edge_mask.all()) and bool(b.node_mask.all())
    assert not bool(b.graph_ids.any())
    moved = b.to("cpu")
    assert moved.n_nodes == 60 and moved.n_edges == 240
    assert moved.positions is None and torch.equal(moved.node_feat,
                                                   b.node_feat)


def _csr_graph(rng, V, E):
    """Edges out of the first half of the vertices only: the second half
    has degree 0."""
    src = rng.integers(0, V // 2, E)
    dst = rng.integers(0, V, E)
    return src.astype(np.int32), dst.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 7])
def test_sampler_bit_equal(seed):
    rng = np.random.default_rng(seed)
    V = 200
    src, dst = _csr_graph(rng, V, 900)
    got = tsampler.build_csr(V, src, dst)
    want = jsampler.build_csr(V, src, dst)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    indptr, indices = got
    seeds = rng.choice(V, 32, replace=False).astype(np.int32)
    seeds[:4] = [V - 1, V - 2, V - 3, V - 4]        # degree 0
    out = tsampler.sample_khop(indptr, indices, seeds, (5, 3), seed=seed)
    ref = jsampler.sample_khop(indptr, indices, seeds, (5, 3), seed=seed)
    assert len(out) == 4
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    nodes, snd, rcv, mask = out
    assert nodes.shape == (32 * (1 + 5 + 15),) and snd.shape == (32 * 20,)
    assert not mask[:20].any()                      # the degree-0 seeds


def test_sampler_over_a_live_csr_snapshot():
    V = 300
    rng = np.random.default_rng(5)
    gj = jsg.empty(V, np.full(V, 2, np.int32), 1024)
    gt = to_port(gj)
    for _ in range(3):
        s = rng.integers(0, V // 2, 200)
        d = rng.integers(0, V, 200)
        gj = jsg.ensure_capacity(gj, 256)
        gt = tsg.ensure_capacity(gt, 256)
        gj, _ = jbatch.insert_edges(gj, jids(s), jids(d))
        gt, _ = tbatch.insert_edges(gt, ids(s), ids(d))
        gj, _ = jbatch.delete_edges(gj, jids(s[:40]), jids(d[:40]))
        gt, _ = tbatch.delete_edges(gt, ids(s[:40]), ids(d[:40]))
    cap = 4096
    t, j = csr_snapshot(gt, max_edges=cap), jcsr(gj, max_edges=cap)
    n = int(t.n_edges)
    assert n == int(j.n_edges) and n > 0
    tptr = t.indptr.numpy().astype(np.int64)
    jptr = np.asarray(j.indptr).astype(np.int64)
    tind, jind = t.indices.numpy()[:n], np.asarray(j.indices)[:n]
    assert np.array_equal(tptr, jptr) and np.array_equal(tind, jind)
    seeds = np.arange(0, V, 9, dtype=np.int32)     # some of degree 0
    out = tsampler.sample_khop(tptr, tind, seeds, (15, 10), seed=1)
    ref = jsampler.sample_khop(jptr, jind, seeds, (15, 10), seed=1)
    for a, b in zip(out, ref):
        assert np.array_equal(a, b)
    nodes, snd, rcv, mask = out
    assert mask.any() and not mask.all()
    # every sampled edge is a live edge of the graph
    live = set(zip(np.repeat(np.arange(V), np.diff(tptr)).tolist(),
                   tind.tolist()))
    assert all((r, s) in live for s, r in zip(snd[mask].tolist(),
                                              rcv[mask].tolist()))


@pytest.mark.parametrize("arch", ["mace", "nequip", "pna", "equiformer-v2"])
def test_launcher_trains_a_gnn_on_cpu(arch, tmp_path, capsys):
    out = tlaunch.main(["--arch", arch, "--device", "cpu", "--steps", "3",
                        "--ckpt-every", "3", "--ckpt-dir", str(tmp_path)])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert tckpt.latest_step(tmp_path) == 3
    assert "[train] done" in capsys.readouterr().out
