"""Port parity: MIND's serving path and ``history_from_slab`` against the
JAX reference on the CPU.

The reference's parameters (its ``init_params`` at MIND's smoke config)
are carried over with ``params_from_numpy``; histories, masks, targets and
candidates come from a numpy seed.  Every function is held in float32
routing within atol 1e-6 / rtol 1e-5 (the values are of order 0.05 to 2;
the differences measured are float32 summation order, below 3e-8), and in
bfloat16 routing within atol 1e-5 / rtol 1e-3 (one bfloat16 rounding of a
product either side).  ``history_from_slab`` is held bit for bit on a
hashed graph whose buckets run to several slabs, with tombstones inside
its rows.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jids, np_of, to_port

from repro.configs import get_arch as jget_arch
from repro.core import iterators as jiter
from repro.core.batch import delete_edges, insert_edges
from repro.core.slab_graph import empty, ensure_capacity, \
    update_slab_pointers
from repro.models.recsys import mind as jmind
from repro_torch.configs import get_arch
from repro_torch.configs.common import LM_SHAPES, RECSYS_SHAPES
from repro_torch.models.recsys import mind as tmind

TOL = {"f32": dict(atol=1e-6, rtol=1e-5), "bf16": dict(atol=1e-5, rtol=1e-3)}
B = 8


@pytest.fixture(scope="module")
def params():
    jcfg = jget_arch("mind").smoke_config()
    jp = jmind.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, tmind.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _configs(routing_dtype="f32", neg_groups=1):
    kw = dict(routing_dtype=routing_dtype, neg_groups=neg_groups)
    return (dataclasses.replace(jget_arch("mind").smoke_config(), **kw),
            dataclasses.replace(get_arch("mind").smoke_config(), **kw))


def _batch(cfg, seed=0):
    """Histories with -1 padding where the mask is 0, targets."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, cfg.n_items, (B, cfg.hist_len)).astype(np.int32)
    mask = (rng.random((B, cfg.hist_len)) < 0.7).astype(np.float32)
    mask[0] = 0.0                               # an empty history
    hist[mask == 0] = -1
    target = rng.integers(0, cfg.n_items, B).astype(np.int32)
    return hist, mask, target


def close(got, want, dtype, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype],
                               err_msg=what)


def test_config_and_shapes_match_reference():
    from repro.configs import common as jcommon
    assert RECSYS_SHAPES == jcommon.RECSYS_SHAPES
    assert LM_SHAPES == jcommon.LM_SHAPES
    for which in ("full_config", "smoke_config"):
        got = dataclasses.asdict(getattr(get_arch("mind"), which)())
        want = dataclasses.asdict(getattr(jget_arch("mind"), which)())
        assert got == want, which
    assert get_arch("mind").FAMILY == "recsys"


def test_squash_matches_reference():
    v = np.random.default_rng(1).standard_normal((5, 4, 16)) \
        .astype(np.float32)
    v[0, 0] = 0.0
    close(tmind.squash(torch.from_numpy(v)), jmind.squash(jnp.asarray(v)),
          "f32", "squash")


@pytest.mark.parametrize("routing_dtype", ["f32", "bf16"])
def test_extract_interests_matches_reference(params, routing_dtype):
    jp, tp = params
    jcfg, cfg = _configs(routing_dtype)
    hist, mask, _ = _batch(cfg)
    want = jmind.extract_interests(jp, jnp.asarray(hist), jnp.asarray(mask),
                                   jcfg)
    got = tmind.extract_interests(tp, torch.from_numpy(hist),
                                  torch.from_numpy(mask), cfg)
    assert got.dtype == torch.float32
    assert got.shape == (B, cfg.n_interests, cfg.embed_dim)
    close(got, want, routing_dtype, "interests")


def test_label_aware_attention_matches_reference():
    rng = np.random.default_rng(3)
    interests = rng.standard_normal((B, 4, 16)).astype(np.float32)
    target = rng.standard_normal((B, 16)).astype(np.float32)
    for p in (1.0, 2.0):
        close(tmind.label_aware_attention(torch.from_numpy(interests),
                                          torch.from_numpy(target), p),
              jmind.label_aware_attention(jnp.asarray(interests),
                                          jnp.asarray(target), p),
              "f32", f"p={p}")


@pytest.mark.parametrize("routing_dtype", ["f32", "bf16"])
def test_serve_and_retrieval_scores_match_reference(params, routing_dtype):
    jp, tp = params
    jcfg, cfg = _configs(routing_dtype)
    hist, mask, _ = _batch(cfg, seed=4)
    rng = np.random.default_rng(5)
    cand = rng.integers(0, cfg.n_items, 37).astype(np.int32)
    emb = rng.standard_normal((50, cfg.embed_dim)).astype(np.float32)
    args = (torch.from_numpy(hist), torch.from_numpy(mask))
    jargs = (jnp.asarray(hist), jnp.asarray(mask))
    got = tmind.serve_scores(tp, *args, torch.from_numpy(cand), cfg)
    assert got.shape == (B, 37)
    close(got, jmind.serve_scores(jp, *jargs, jnp.asarray(cand), jcfg),
          routing_dtype, "serve_scores")
    got = tmind.retrieval_scores(tp, *args, torch.from_numpy(emb), cfg)
    assert got.shape == (B, 50)
    close(got, jmind.retrieval_scores(jp, *jargs, jnp.asarray(emb), jcfg),
          routing_dtype, "retrieval_scores")


@pytest.mark.parametrize("routing_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("neg_groups", [1, 2])
def test_train_loss_matches_reference(params, routing_dtype, neg_groups):
    jp, tp = params
    jcfg, cfg = _configs(routing_dtype, neg_groups)
    hist, mask, target = _batch(cfg, seed=6)
    got = tmind.train_loss(tp, torch.from_numpy(hist),
                           torch.from_numpy(mask), torch.from_numpy(target),
                           cfg)
    assert got.shape == () and got.dtype == torch.float32
    close(got, jmind.train_loss(jp, jnp.asarray(hist), jnp.asarray(mask),
                                jnp.asarray(target), jcfg),
          routing_dtype, "train_loss")


def test_init_params_shapes_and_scales():
    cfg = get_arch("mind").smoke_config()
    want = jmind.init_params(jget_arch("mind").smoke_config(),
                             jax.random.PRNGKey(0))
    got = tmind.init_params(cfg, torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == torch.float32
    assert abs(float(got["item_embed"].std()) / 0.05 - 1) < 0.1
    assert abs(float(got["S"].std()) / cfg.embed_dim ** -0.5 - 1) < 0.2


# ---------------------------------------------------------------------------
# histories out of a live SlabGraph
# ---------------------------------------------------------------------------

V, CAP = 64, 1024
LANES = 512


def _live_graph():
    """Three buckets a vertex; users 0 and 5 hold 700 and 300 items, so
    their buckets run to several slabs; random edges elsewhere; then a
    delete batch (tombstones inside rows, user 0's first bucket among
    them) and an insert batch into the open epoch's rows."""
    rng = np.random.default_rng(21)
    g = empty(V, np.full(V, 3, np.int32), CAP)
    s = np.concatenate([np.zeros(700, np.int64), np.full(300, 5),
                        rng.integers(0, V, 200)])
    d = np.concatenate([1000 + np.arange(700), 3000 + np.arange(300),
                        rng.integers(0, 900, 200)])
    for lo in range(0, len(s), LANES):
        g, _ = insert_edges(g, jids(s[lo:lo + LANES], LANES),
                            jids(d[lo:lo + LANES], LANES))
        g = update_slab_pointers(g)
    pick = rng.choice(len(s), 250, replace=False)
    g, _ = delete_edges(g, jids(s[pick], LANES), jids(d[pick], LANES))
    g = ensure_capacity(update_slab_pointers(g), LANES + 64)
    s2 = np.concatenate([np.zeros(40, np.int64), rng.integers(0, V, 60)])
    d2 = np.concatenate([5000 + np.arange(40), rng.integers(0, 900, 60)])
    g, _ = insert_edges(g, jids(s2, LANES), jids(d2, LANES))
    return g


@pytest.fixture(scope="module")
def live_graph():
    gj = _live_graph()
    return gj, to_port(gj)


@pytest.mark.parametrize("hist_len", [12, 50, 400])
def test_history_from_slab_matches_reference(live_graph, hist_len):
    """Every vertex, in a shuffled order with repeats: histories and masks
    bit-equal to the reference's vmap of ``slab_iterator`` (its first
    bucket only).  User 0's first bucket runs to several slabs and holds
    about 230 items: at 12 and 50 its history is cut inside the chain, at
    400 it is the whole bucket."""
    gj, gt = live_graph
    users = np.random.default_rng(2).permutation(
        np.concatenate([np.arange(V), [0, 5, 0]])).astype(np.int32)
    want_h, want_m = jmind.history_from_slab(gj, jnp.asarray(users),
                                             hist_len=hist_len)
    got_h, got_m = tmind.history_from_slab(gt, torch.from_numpy(users),
                                           hist_len=hist_len)
    assert got_h.dtype == torch.int32 and got_m.dtype == torch.float32
    assert np.array_equal(np_of(got_h), np_of(want_h))
    assert np.array_equal(got_m.numpy(), np.asarray(want_m))
    first = int(gj.bucket_offset[0])
    assert int(gj.next_slab[first]) != -1
    n_first = int(jiter.bucket_iterator(gj, jnp.int32(0), jnp.int32(0),
                                        max_neighbors=4096)[1])
    assert 128 < n_first < 400
    hub = int(np.flatnonzero(users == 0)[0])
    assert int(got_m[hub].sum()) == min(hist_len, n_first)


def test_history_feeds_serve_scores(live_graph, params):
    """Histories from the graph through ``serve_scores`` (item ids taken
    modulo the smoke table) equal the reference's."""
    gj, gt = live_graph
    jp, tp = params
    jcfg, cfg = _configs()
    users = np.arange(V, dtype=np.int32)
    hist, mask = tmind.history_from_slab(gt, torch.from_numpy(users),
                                         hist_len=cfg.hist_len)
    hist = torch.where(hist >= 0, hist % cfg.n_items, hist)
    cand = np.arange(0, cfg.n_items, 7, dtype=np.int32)
    got = tmind.serve_scores(tp, hist, mask, torch.from_numpy(cand), cfg)
    want = jmind.serve_scores(jp, jnp.asarray(hist.numpy()),
                              jnp.asarray(mask.numpy()), jnp.asarray(cand),
                              jcfg)
    close(got, want, "f32", "scores of graph histories")
