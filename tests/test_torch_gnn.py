"""Port parity: the GNN family (``models/gnn/*``, ``launch/steps.py``'s
``build_gnn_train_step``) against ``repro.models.gnn`` on the CPU.

Inputs are made with numpy from a seed and go through both packages; the
reference's weights reach the port through ``params_from_numpy``.  Float32
throughout, held to atol 1e-5 / rtol 1e-4 (two frameworks' float32
summation orders through segment sums, batched products and a few layers;
measured below 4e-5 absolute on gradients of order 10 and within the
relative bound everywhere):

* the building blocks: ``equivariant_conv``, ``tensor_power``, ``gate``,
  ``segment_softmax`` (with a duplicated edge, so that a max ties) and
  PNA's ``_aggregate`` (with a node whose only edges are masked), their
  outputs and the gradients of a fixed projection of them;
* for each of the four smoke configs, on the batches of
  ``tests/test_arch_smoke.py::test_gnn_smoke_train`` (48 nodes, 200 edges,
  4 graphs; 60 nodes, 240 edges): the forward, the loss, every gradient
  leaf against ``jax.value_and_grad`` (the port's flattened leaf order is
  JAX's) and one ``build_gnn_train_step`` step (parameters and AdamW
  moments) against the reference's step;
* every gradient leaf finite on batches with self-loops and padded edges
  (zero edge vectors), whose positions take no gradient.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import steps as jsteps
from repro.models.gnn import common as jcommon
from repro.models.gnn import pna as jpna
from repro.models.gnn import tensor_field as jtf
from repro.train import optimizer as jopt
from repro_torch.configs import get_arch
from repro_torch.core import tree as ttree
from repro_torch.launch import steps as tsteps
from repro_torch.models.gnn import common as tcommon
from repro_torch.models.gnn import pna as tpna
from repro_torch.models.gnn import tensor_field as ttf
from repro_torch.train import optimizer as topt

ARCHS = ["mace", "nequip", "pna", "equiformer-v2"]
TOL = dict(atol=1e-5, rtol=1e-4)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def geometric_np(rng, n_nodes, n_edges, *, n_graphs, n_species):
    """A batch shaped as ``random_geometric_batch``'s, from numpy: edges
    within each graph's partition, self-loops masked, not removed."""
    pos = rng.uniform(0, 1, (n_nodes, 3)) * (n_nodes ** (1 / 3)) * 2.0
    per = n_nodes // n_graphs
    off = np.repeat(np.arange(n_graphs) * per, n_edges // n_graphs)
    snd = rng.integers(0, per, n_edges) + off
    rcv = rng.integers(0, per, n_edges) + off
    return dict(positions=pos.astype(np.float32), node_feat=None,
                species=rng.integers(0, n_species, n_nodes).astype(np.int32),
                senders=snd.astype(np.int32), receivers=rcv.astype(np.int32),
                edge_mask=snd != rcv, node_mask=np.ones(n_nodes, bool),
                graph_ids=np.repeat(np.arange(n_graphs),
                                    per).astype(np.int32)), n_graphs


def feature_np(rng, n_nodes, n_edges, d_feat):
    return dict(positions=None,
                node_feat=rng.standard_normal((n_nodes, d_feat))
                .astype(np.float32), species=None,
                senders=rng.integers(0, n_nodes, n_edges).astype(np.int32),
                receivers=rng.integers(0, n_nodes, n_edges).astype(np.int32),
                edge_mask=np.ones(n_edges, bool),
                node_mask=np.ones(n_nodes, bool),
                graph_ids=np.zeros(n_nodes, np.int32)), 1


def both(fields, n_graphs):
    """The same batch as the reference's GraphBatch and the port's."""
    jb = jcommon.GraphBatch(**{k: None if v is None else jnp.asarray(v)
                               for k, v in fields.items()},
                            n_graphs=n_graphs)
    tb = tcommon.GraphBatch(**{k: None if v is None else torch.from_numpy(v)
                               for k, v in fields.items()},
                            n_graphs=n_graphs)
    return jb, tb


def smoke_setup(arch):
    """(reference module, config, params; port module, config, params;
    the batch in both packages; targets) as test_gnn_smoke_train builds
    them, from numpy."""
    jmod, style = jsteps._GNN[arch]
    tmod, tstyle = tsteps._GNN[arch]
    assert style == tstyle
    jcfg = jget_arch(arch).smoke_config()
    cfg = get_arch(arch).smoke_config()
    rng = np.random.default_rng(11)
    if style == "geometric":
        fields, G = geometric_np(rng, 48, 200, n_graphs=4,
                                 n_species=cfg.n_species)
        targets = rng.standard_normal(G).astype(np.float32)
    else:
        fields, G = feature_np(rng, 60, 240, cfg.d_in)
        targets = rng.integers(0, cfg.n_classes, 60).astype(np.int32)
    jb, tb = both(fields, G)
    jp = jmod.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tmod.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return (jmod, jcfg, jp, tmod, cfg, tp, style, jb, tb, targets)


def loss_of(mod, cfg, style):
    if style == "geometric":
        return lambda p, b, t: mod.energy_loss(p, b, t, cfg)
    return lambda p, b, t: mod.node_xent_loss(p, b, t, cfg)


def assert_trees_close(got, want, what, **tol):
    g, w = ttree.tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert tuple(a.shape) == np.shape(b), (what, i)
        np.testing.assert_allclose(_np(a), _np(b), **(tol or TOL),
                                   err_msg=f"{what} leaf {i}")


def reference_value_and_grad(jmod, jcfg, style, jp, jb, targets):
    """The reference's loss and gradients, jitted (its op-by-op dispatch
    of the Wigner recursion takes tens of seconds on the CPU)."""
    return jax.jit(jax.value_and_grad(loss_of(jmod, jcfg, style)))(
        jp, jb, jnp.asarray(targets))


def reference_forward(jmod, jcfg, jp, jb):
    return jax.jit(lambda p, b: jmod.forward(p, b, jcfg))(jp, jb)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def _irrep_feats(rng, n, c, ls):
    return {l: rng.standard_normal((n, c, 2 * l + 1)).astype(np.float32)
            for l in ls}


def test_equivariant_conv_matches_reference():
    rng = np.random.default_rng(0)
    fields, G = geometric_np(rng, 24, 90, n_graphs=2, n_species=5)
    jb, tb = both(fields, G)
    kw = dict(l_max=2, channels=4, n_rbf=6, cutoff=5.0)
    jp = jtf.init_conv(jax.random.PRNGKey(1), l_max=2, channels=4, n_rbf=6)
    tp = tcommon.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    h = _irrep_feats(rng, 24, 4, (0, 1))
    proj = _irrep_feats(rng, 24, 4, (0, 1, 2))

    def jloss(p, hh):
        out = jtf.equivariant_conv(p, hh, jb, **kw)
        return sum(jnp.sum(out[l] * proj[l]) for l in out), out

    (jv, jout), (jgp, jgh) = jax.value_and_grad(jloss, argnums=(0, 1),
                                                has_aux=True)(
        jp, {l: jnp.asarray(v) for l, v in h.items()})
    th = {l: torch.from_numpy(v).requires_grad_() for l, v in h.items()}
    tpp = ttree.tree_map(lambda x: x.requires_grad_(), tp)
    out = ttf.equivariant_conv(tpp, th, tb, **kw)
    assert list(out) == list(jout) == [0, 1, 2]
    for l in out:
        np.testing.assert_allclose(_np(out[l]), _np(jout[l]), **TOL)
    tv = sum((out[l] * torch.from_numpy(proj[l])).sum() for l in out)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), **TOL)
    assert_trees_close(ttree.tree_map(lambda x: x.grad, tpp), jgp, "conv")
    for l in h:
        np.testing.assert_allclose(_np(th[l].grad), _np(jgh[l]), **TOL)


def test_tensor_power_matches_reference():
    rng = np.random.default_rng(1)
    ls = (0, 1, 2)
    h, A = _irrep_feats(rng, 20, 6, ls), _irrep_feats(rng, 20, 6, ls)
    jw = jtf.init_tensor_power(jax.random.PRNGKey(2), ls, ls, ls, 6)
    tw = tcommon.params_from_numpy(jax.tree.map(np.asarray, jw), "cpu")
    proj = _irrep_feats(rng, 20, 6, ls)

    def jloss(hh, aa, w):
        out = jtf.tensor_power(hh, aa, w, ls)
        return sum(jnp.sum(out[l] * proj[l]) for l in out), out

    (jv, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                        has_aux=True)(
        {l: jnp.asarray(v) for l, v in h.items()},
        {l: jnp.asarray(v) for l, v in A.items()}, jw)
    th = {l: torch.from_numpy(v).requires_grad_() for l, v in h.items()}
    tA = {l: torch.from_numpy(v).requires_grad_() for l, v in A.items()}
    tww = ttree.tree_map(lambda x: x.requires_grad_(), tw)
    out = ttf.tensor_power(th, tA, tww, ls)
    assert list(out) == list(jout)
    for l in out:
        np.testing.assert_allclose(_np(out[l]), _np(jout[l]), **TOL)
    tv = sum((out[l] * torch.from_numpy(proj[l])).sum() for l in out)
    tv.backward()
    for l in ls:
        np.testing.assert_allclose(_np(th[l].grad), _np(jg[0][l]), **TOL)
        np.testing.assert_allclose(_np(tA[l].grad), _np(jg[1][l]), **TOL)
    assert_trees_close(ttree.tree_map(lambda x: x.grad, tww), jg[2], "w")


def test_gate_matches_reference():
    rng = np.random.default_rng(2)
    h = _irrep_feats(rng, 10, 5, (0, 1, 2))
    w = rng.standard_normal((5, 5)).astype(np.float32)
    got = ttf.gate({l: torch.from_numpy(v) for l, v in h.items()},
                   torch.from_numpy(w))
    want = jtf.gate({l: jnp.asarray(v) for l, v in h.items()},
                    jnp.asarray(w))
    assert list(got) == list(want)
    for l in got:
        np.testing.assert_allclose(_np(got[l]), _np(want[l]), **TOL)
    only = ttf.gate({0: torch.from_numpy(h[0])}, torch.from_numpy(w))
    assert list(only) == [0]


def test_segment_softmax_matches_reference_with_a_tied_max():
    """Edge 1 is edge 0 again (a tied max); segment 2's only edge is
    masked; segment 4 has no edge."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal(12).astype(np.float32)
    segs = np.array([0, 0, 0, 1, 1, 2, 3, 3, 3, 3, 1, 0], np.int32)
    logits[1] = logits[0] = logits.max() + 1.0
    mask = np.ones(12, bool)
    mask[5] = False
    mask[7] = False
    proj = rng.standard_normal(12).astype(np.float32)

    def jf(x):
        out = jcommon.segment_softmax(x, jnp.asarray(segs), 5,
                                      jnp.asarray(mask))
        return jnp.sum(out * proj), out

    (jv, jout), jg = jax.value_and_grad(jf, has_aux=True)(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    out = tcommon.segment_softmax(x, torch.from_numpy(segs), 5,
                                  torch.from_numpy(mask))
    (out * torch.from_numpy(proj)).sum().backward()
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    np.testing.assert_allclose(_np(x.grad), _np(jg), **TOL)
    out = out.detach()
    assert float(out[5]) == 0.0 and float(out[0]) == float(out[1])


def test_pna_aggregate_matches_reference():
    """Node 3's only edges are masked, node 5 has none, and two edges into
    node 0 carry the same message (a tied max and min)."""
    rng = np.random.default_rng(4)
    msg = rng.standard_normal((14, 6)).astype(np.float32)
    rcv = np.array([0, 0, 1, 1, 1, 2, 3, 3, 4, 4, 0, 2, 4, 1], np.int32)
    msg[10] = msg[0]
    emask = np.ones(14, bool)
    emask[[6, 7]] = False
    deg = np.bincount(rcv[emask], minlength=6).astype(np.float32)
    proj = rng.standard_normal((6, 72)).astype(np.float32)

    def jf(m):
        out = jpna._aggregate(m, jnp.asarray(rcv), jnp.asarray(emask), 6,
                              jnp.asarray(deg), 2.5)
        return jnp.sum(out * proj), out

    (jv, jout), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(msg))
    m = torch.from_numpy(msg).requires_grad_()
    out = tpna._aggregate(m, torch.from_numpy(rcv), torch.from_numpy(emask),
                          6, torch.from_numpy(deg), 2.5)
    (out * torch.from_numpy(proj)).sum().backward()
    assert out.shape == (6, 72)
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    np.testing.assert_allclose(_np(m.grad), _np(jg), **TOL)
    assert np.isfinite(_np(m.grad)).all()


# ---------------------------------------------------------------------------
# the four models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_reference(arch):
    (jmod, jcfg, jp, tmod, cfg, tp, style, jb, tb,
     targets) = smoke_setup(arch)
    want = reference_forward(jmod, jcfg, jp, jb)
    got = tmod.forward(tp, tb, cfg)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    jv, jg = reference_value_and_grad(jmod, jcfg, style, jp, jb, targets)
    tv, tg = tsteps.value_and_grad(loss_of(tmod, cfg, style), tp, tb,
                                   torch.from_numpy(targets))
    assert tv.shape == () and tv.dtype == torch.float32
    np.testing.assert_allclose(float(tv), float(jv), **TOL)
    # the port's flattened leaf order is JAX's
    jpaths = ["/".join(str(k.key) for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [p.lstrip("/") for p, _ in ttree.flatten(tp)[0]] == jpaths
    assert_trees_close(tg, jg, "grads")
    assert all(np.isfinite(_np(g)).all() for g in ttree.tree_leaves(tg))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    (jmod, jcfg, jp, tmod, cfg, tp, style, jb, tb,
     targets) = smoke_setup(arch)
    jstep = jax.jit(jsteps.build_gnn_train_step(jmod, jcfg, style))
    tstep = tsteps.build_gnn_train_step(tmod, cfg, style)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(2):
        jp, js, jl = jstep(jp, js, jb, jnp.asarray(targets))
        tp, ts, tl = tstep(tp, ts, tb, torch.from_numpy(targets))
        np.testing.assert_allclose(float(tl), float(jl), **TOL)
        assert_trees_close(tp, jp, f"params after step {i + 1}")
        assert_trees_close((ts.m, ts.v), (js.m, js.v),
                           f"moments after step {i + 1}")
        assert int(ts.count) == int(js.count) == i + 1


@pytest.mark.parametrize("arch", ["mace", "nequip", "equiformer-v2"])
def test_grads_finite_with_self_loops_and_padded_edges(arch):
    """Self-loops masked and a padded tail of edges pointing at node 0
    (zero edge vectors, whose norm has no finite gradient): every gradient
    leaf is finite, and the positions record no gradient."""
    (_, _, _, tmod, cfg, tp, style, _, tb, targets) = smoke_setup(arch)
    E = tb.n_edges
    pad = 40
    z = torch.zeros(pad, dtype=torch.int32)
    tb = dataclasses.replace(
        tb, senders=torch.cat([tb.senders, z]),
        receivers=torch.cat([tb.receivers, z]),
        edge_mask=torch.cat([tb.edge_mask, torch.zeros(pad, dtype=bool)]))
    assert bool((tb.senders[:E] == tb.receivers[:E]).any())
    tv, tg = tsteps.value_and_grad(loss_of(tmod, cfg, style), tp, tb,
                                   torch.from_numpy(targets))
    assert np.isfinite(float(tv))
    assert all(np.isfinite(_np(g)).all() for g in ttree.tree_leaves(tg))
    assert not tb.positions.requires_grad and tb.positions.grad is None
