"""Port parity: the dry run's levers against the reference on the CPU,
with the same flags on both sides and the reference's weights carried over.

* ``LMConfig.cast_params_once`` on gemma-2b's smoke config in bf16: the
  forward, the loss and every gradient leaf.
* The one-layer alternating stack (gemma2-9b's smoke config cut to one
  layer: the reference runs its single layer as a local/global pair in
  ``forward`` and ``prefill``, and as a local layer in ``decode_step``):
  ``forward``, the loss and every gradient leaf, ``TransformerLM``'s
  forward and prefill, and a decode sequence, float32.
* EquiformerV2's ``edge_chunks`` in {1, 2} (200 edge slots, the last 8
  padding, as the reference's dry run pads edges to whole chunks), with
  ``trunc_rotation`` off and on, in float32 and with ``compute_dtype``
  bf16 (``EQ_CASES``: each value at least once, on the smoke config cut
  to one layer): the energies, the loss and every gradient leaf.

Each lever is checked twice: by value against the reference, and by
structure, since a lever can change what runs without changing the
values.  ``cast_params_once`` must cast every float32 parameter leaf to
bf16 once, before the first product (the lever off casts each layer's
slice inside the loop, with equal values).  EquiformerV2's forward must
hold the reference's matrix-product flops per operand dtype (``_flops``:
the port's ``FlopCounterMode`` formulas against the reference jaxpr's
``dot_general``s), so an ignored ``compute_dtype`` (no bf16 products), an
untruncated rotation (more flops, the same values: the truncation is
exact) or a dropped edge chunk (fewer) fails.

Tolerances: float32 atol 1e-5 / rtol 1e-4 (as the existing LM and GNN
parity tests).  bf16: the two frameworks round bf16 products and sums
differently, so each bound sits between the sound run's CPU reading and a
control's (``test_*_controls_fail``).  gemma-2b's smoke LM: logits 2.3e-3
of their largest magnitude, loss 7.5e-5 relative, gradients 8.6e-3 of the
largest; the control, the same port in float32, 3.2e-3, 4.3e-4 and
9.5e-3: ``LM_BF16_*`` = 5e-3, 2e-4, 2e-2 (the control fails the loss
bound).  EquiformerV2 (one layer): energies 1.36e-3 of their largest,
loss 1.45e-3, gradients 1.10e-3 of the largest, in every bf16 case; the
controls: float32 compute 3.99e-3, 1.32e-3, 2.13e-3 (it fails the
energies bound and the dtype flops); the last of two edge chunks dropped
0.78, 0.45, 0.35 (all three bounds and the flops); the untruncated
rotation the sound readings (the flops only): ``EQ_BF16_*`` = 3e-3, 5e-3,
5e-3.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _flops import MatmulFlops, jaxpr_dot_flops_by_dtype
from repro.configs import get_arch as jget_arch
from repro.launch import steps as jsteps
from repro.models import transformer as jtfm
from repro.models.gnn import common as jcommon
from repro_torch.configs import get_arch
from repro_torch.core import tree as ttree
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as ttfm
from repro_torch.models.gnn import common as tcommon
from repro_torch.models.transformer import TransformerLM, params_from_numpy

TOL = dict(atol=1e-5, rtol=1e-4)
#: bf16 bounds (output: of its largest magnitude; loss: relative;
#: gradients: every leaf's largest difference over the largest gradient)
LM_BF16_OUT, LM_BF16_LOSS, LM_BF16_GRAD = 5e-3, 2e-4, 2e-2
EQ_BF16_OUT, EQ_BF16_LOSS, EQ_BF16_GRAD = 3e-3, 5e-3, 5e-3


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close_trees(got, want, what=""):
    g, w = ttree.tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, (what, i)
        np.testing.assert_allclose(a, b, **TOL, err_msg=f"{what} {i}")


def _readings(out, want_out, loss, want_loss, grads, want_grads) -> dict:
    """The bf16 readings: the output's largest difference over its largest
    magnitude, the loss's relative difference, and every gradient leaf's
    largest difference over the largest gradient."""
    g, w = ttree.tree_leaves(grads), jax.tree.leaves(want_grads)
    assert len(g) == len(w) and all(_np(a).shape == _np(b).shape
                                    for a, b in zip(g, w))
    top = max(np.abs(_np(b)).max() for b in w)
    out, want_out = _np(out), _np(want_out)
    return {"out": float(np.abs(out - want_out).max()
                         / np.abs(want_out).max()),
            "loss": abs(float(loss) - float(want_loss)) / abs(float(want_loss)),
            "grad": float(max(np.abs(_np(a) - _np(b)).max()
                              for a, b in zip(g, w)) / top)}


def _within(r: dict, bounds) -> dict:
    """Which of ``r``'s readings lie within ``bounds`` (out, loss, grad)."""
    return {k: r[k] <= b for k, b in zip(("out", "loss", "grad"), bounds)}


def _lm(arch, seed=3, **flags):
    jcfg = dataclasses.replace(jget_arch(arch).smoke_config(), **flags)
    tflags = dict(flags)
    if "dtype" in tflags:
        tflags["dtype"] = torch.bfloat16
    cfg = dataclasses.replace(get_arch(arch).smoke_config(), **tflags)
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    return jcfg, jp, cfg, tp, toks, labels


def _loss_and_grads(jcfg, jp, cfg, tp, toks, labels):
    want, jg = jax.jit(jax.value_and_grad(jtfm.loss_fn), static_argnums=3)(
        jp, jnp.asarray(toks), jnp.asarray(labels), jcfg)
    got, g = tsteps.value_and_grad(
        lambda p, t, l: ttfm.loss_fn(p, t, l, cfg), tp,
        torch.from_numpy(toks), torch.from_numpy(labels))
    return float(got), g, float(want), jg


class _Casts(TorchDispatchMode):
    """The float32 -> bf16 casts that read a parameter's storage, and
    whether each came before the first matrix product."""

    def __init__(self, params):
        super().__init__()
        self.storages = {t.untyped_storage().data_ptr()
                         for t in ttree.tree_leaves(params)}
        self.casts, self.products = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._overloadpacket.__name__
        if name in ("mm", "addmm", "bmm"):
            self.products += 1
        elif (name == "_to_copy" and args[0].dtype == torch.float32
              and (kwargs or {}).get("dtype") == torch.bfloat16
              and args[0].untyped_storage().data_ptr() in self.storages):
            self.casts.append(self.products == 0)
        return func(*args, **(kwargs or {}))


def _cast_once_holds(cfg, tp, toks) -> bool:
    """Every float32 parameter leaf cast to bf16 exactly once, before the
    first product."""
    mode = _Casts(tp)
    with torch.no_grad(), mode:
        ttfm.forward(tp, torch.from_numpy(toks), cfg)
    n32 = sum(t.dtype == torch.float32 for t in ttree.tree_leaves(tp))
    return n32 > 0 and len(mode.casts) == n32 and all(mode.casts)


def _lm_readings(jcfg, jp, cfg, tp, toks, labels) -> dict:
    want = jax.jit(jtfm.forward, static_argnums=2)(jp, jnp.asarray(toks),
                                                   jcfg)
    got = ttfm.forward(tp, torch.from_numpy(toks), cfg)
    gl, g, wl, wg = _loss_and_grads(jcfg, jp, cfg, tp, toks, labels)
    return _readings(got, want, gl, wl, g, wg)


LM_BOUNDS = (LM_BF16_OUT, LM_BF16_LOSS, LM_BF16_GRAD)


def test_cast_params_once_bf16_matches_reference():
    jcfg, jp, cfg, tp, toks, labels = _lm(
        "gemma-2b", dtype=jnp.bfloat16, cast_params_once=True)
    got = ttfm.forward(tp, torch.from_numpy(toks), cfg)
    assert got.dtype == torch.bfloat16
    r = _lm_readings(jcfg, jp, cfg, tp, toks, labels)
    assert all(_within(r, LM_BOUNDS).values()), r
    assert _cast_once_holds(cfg, tp, toks)
    # the lever moves the casts, not the forward's values
    plain = dataclasses.replace(cfg, cast_params_once=False)
    assert torch.equal(ttfm.forward(tp, torch.from_numpy(toks), plain), got)


def test_cast_params_once_controls_fail():
    """The lever off passes the value bounds (its values are the lever's)
    but casts each layer's slice inside the loop; the same port in float32
    fails the loss bound."""
    jcfg, jp, cfg, tp, toks, labels = _lm(
        "gemma-2b", dtype=jnp.bfloat16, cast_params_once=True)
    off = dataclasses.replace(cfg, cast_params_once=False)
    assert not _cast_once_holds(off, tp, toks)
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    r = _lm_readings(jcfg, jp, f32, tp, toks, labels)
    assert not _within(r, LM_BOUNDS)["loss"], r


def test_one_layer_alternating_stack_matches_reference():
    jcfg, jp, cfg, tp, toks, labels = _lm("gemma2-9b", n_layers=1)
    assert cfg.has_local and cfg.n_layers == 1
    want = jax.jit(jtfm.forward, static_argnums=2)(jp, jnp.asarray(toks),
                                                   jcfg)
    np.testing.assert_allclose(_np(ttfm.forward(tp, torch.from_numpy(toks),
                                                cfg)), _np(want), **TOL)
    model = TransformerLM(cfg, tp)
    np.testing.assert_allclose(_np(model(torch.from_numpy(toks))),
                               _np(want), **TOL)
    gl, g, wl, wg = _loss_and_grads(jcfg, jp, cfg, tp, toks, labels)
    np.testing.assert_allclose(gl, wl, **TOL)
    _close_trees(g, wg, "grads")

    # prefill and a decode sequence against the reference's
    jlog, jcache = jtfm.prefill(jp, jnp.asarray(toks), jcfg)
    tlog, tcache = model.prefill(torch.from_numpy(toks))
    np.testing.assert_allclose(_np(tlog), _np(jlog), **TOL)
    for name in jcache:
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]),
                                   **TOL, err_msg=name)
    B, S, n = toks.shape[0], toks.shape[1], 6
    jc = jtfm.init_cache(jcfg, B, S + n, dtype=jnp.float32)
    tc = ttfm.init_cache(cfg, B, S + n, dtype=torch.float32, device="cpu")
    for name in jc:
        jc[name] = jc[name].at[:, :, :, :S].set(jcache[name])
        tc[name][:, :, :, :S] = tcache[name]
    tok = toks[:, -1]
    for i in range(n):
        jl, jc = jtfm.decode_step(jp, jc, jnp.asarray(tok),
                                  jnp.asarray(S + i, jnp.int32), jcfg)
        tl, tc = model.decode_step(tc, torch.from_numpy(tok), S + i)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL,
                                   err_msg=f"decode {i}")
        for name in jc:
            np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **TOL,
                                       err_msg=f"decode {i} {name}")
        tok = np.asarray(jl).argmax(-1).astype(np.int32)


def _eq_batch(rng, n_nodes=48, n_edges=200, n_graphs=4, n_pad=8,
              n_species=10):
    """The molecule-style batch of ``tests/test_torch_gnn.py`` with the
    last ``n_pad`` edge slots padding (masked, pointing at node 0)."""
    per = n_nodes // n_graphs
    off = np.repeat(np.arange(n_graphs) * per, n_edges // n_graphs)
    snd = rng.integers(0, per, n_edges) + off
    rcv = rng.integers(0, per, n_edges) + off
    mask = snd != rcv
    snd[-n_pad:], rcv[-n_pad:], mask[-n_pad:] = 0, 0, False
    fields = dict(
        positions=(rng.uniform(0, 1, (n_nodes, 3)) * (n_nodes ** (1 / 3))
                   * 2.0).astype(np.float32),
        node_feat=None,
        species=rng.integers(0, n_species, n_nodes).astype(np.int32),
        senders=snd.astype(np.int32), receivers=rcv.astype(np.int32),
        edge_mask=mask, node_mask=np.ones(n_nodes, bool),
        graph_ids=np.repeat(np.arange(n_graphs), per).astype(np.int32))
    jb = jcommon.GraphBatch(**{k: None if v is None else jnp.asarray(v)
                               for k, v in fields.items()},
                            n_graphs=n_graphs)
    tb = tcommon.GraphBatch(**{k: None if v is None else torch.from_numpy(v)
                               for k, v in fields.items()},
                            n_graphs=n_graphs)
    return jb, tb


#: (edge_chunks, trunc_rotation, dtype): each lever value at least once,
#: on the smoke config cut to one layer (the reference's jit compiles of
#: the chunked, checkpointed scan take most of a case's time)
EQ_CASES = [(2, False, "f32"), (1, True, "f32"), (2, True, "bf16"),
            (1, False, "bf16")]


@pytest.fixture(scope="module")
def eq_setup():
    """The reference's smoke parameters (one layer: the levers do not
    change the parameters) in both packages, and a padded batch."""
    jmod, _ = jsteps._GNN["equiformer-v2"]
    tmod, _ = tsteps._GNN["equiformer-v2"]
    jcfg = dataclasses.replace(jget_arch("equiformer-v2").smoke_config(),
                               n_layers=1)
    jp = jmod.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tmod.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(11)
    jb, tb = _eq_batch(rng)
    targets = rng.standard_normal(4).astype(np.float32)
    return jmod, tmod, jp, tp, jb, tb, targets


def _eq_run(eq_setup, chunks, trunc, bf16, *, port=None, fault=None):
    """The reference's loss, energies, gradients and forward dot flops by
    dtype with these levers, and the port's with ``port``'s levers (the
    same by default) under ``fault`` (a context manager, or None)."""
    jmod, tmod, jp, tp, jb, tb, targets = eq_setup
    jflags = dict(edge_chunks=chunks, trunc_rotation=trunc, n_layers=1,
                  compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    jcfg = dataclasses.replace(
        jget_arch("equiformer-v2").smoke_config(), **jflags)
    chunks, trunc, bf16 = port or (chunks, trunc, bf16)
    cfg = dataclasses.replace(
        get_arch("equiformer-v2").smoke_config(), n_layers=1,
        edge_chunks=chunks, trunc_rotation=trunc,
        compute_dtype=torch.bfloat16 if bf16 else torch.float32)

    def jloss(p, b, t):
        e = jmod.forward(p, b, jcfg)
        return jnp.mean((e - t) ** 2), e
    (wl, want_e), wg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jp, jb, jnp.asarray(targets))
    want_f = jaxpr_dot_flops_by_dtype(jax.make_jaxpr(
        lambda p, b: jmod.forward(p, b, jcfg))(jp, jb).jaxpr)
    energies = []

    def tloss(p, b, t):
        e = tmod.forward(p, b, cfg)
        energies.append(e.detach())
        return torch.mean((e - t) ** 2)
    flops = MatmulFlops()
    with fault() if fault else contextlib.nullcontext():
        gl, g = tsteps.value_and_grad(tloss, tp, tb,
                                      torch.from_numpy(targets))
        with torch.no_grad(), flops:
            tmod.forward(tp, tb, cfg)
    return dict(loss=float(gl), want_loss=float(wl), e=energies[0],
                want_e=want_e, g=g, wg=wg, flops=flops.by_dtype,
                want_flops=want_f)


EQ_BOUNDS = (EQ_BF16_OUT, EQ_BF16_LOSS, EQ_BF16_GRAD)


@pytest.mark.parametrize("chunks,trunc,dtype", EQ_CASES,
                         ids=[f"chunks{k}-trunc{int(t)}-{d}"
                              for k, t, d in EQ_CASES])
def test_equiformer_levers_match_reference(eq_setup, chunks, trunc, dtype):
    bf16 = dtype == "bf16"
    run = _eq_run(eq_setup, chunks, trunc, bf16)
    assert run["flops"] == run["want_flops"]
    assert ("bfloat16" in run["flops"]) == bf16
    if bf16:
        assert run["e"].dtype == torch.float32   # the readout is float32
        r = _readings(run["e"], run["want_e"], run["loss"],
                      run["want_loss"], run["g"], run["wg"])
        assert all(_within(r, EQ_BOUNDS).values()), r
    else:
        np.testing.assert_allclose(_np(run["e"]), _np(run["want_e"]), **TOL)
        np.testing.assert_allclose(run["loss"], run["want_loss"], **TOL)
        _close_trees(run["g"], run["wg"], "grads")


@contextlib.contextmanager
def _last_chunk_dropped():
    """A planted fault: the aggregation pass skips the last of two edge
    chunks (its checkpointed call returns the aggregates unchanged)."""
    import torch.utils.checkpoint as ckpt_mod
    real, calls = ckpt_mod.checkpoint, [0]

    def checkpoint(fn, *args, **kw):
        if fn.__name__ == "agg_chunk":
            calls[0] += 1
            if calls[0] % 2 == 0:
                n = (len(args) - 4) // 2
                return tuple(args[4:4 + n])
        return real(fn, *args, **kw)
    ckpt_mod.checkpoint = checkpoint
    try:
        yield
    finally:
        ckpt_mod.checkpoint = real


#: (name, the reference's levers, the port's levers, fault, the readings
#: that must break their bound)
EQ_CONTROLS = [
    ("f32", (1, False, True), (1, False, False), None, ("out",)),
    ("drop", (2, False, True), None, _last_chunk_dropped,
     ("out", "loss", "grad")),
    ("untrunc", (1, True, True), (1, False, True), None, ()),
]


@pytest.mark.parametrize("name,ref,port,fault,broken", EQ_CONTROLS,
                         ids=[c[0] for c in EQ_CONTROLS])
def test_equiformer_lever_controls_fail(eq_setup, name, ref, port, fault,
                                        broken):
    """Each control fails what it must: an ignored ``compute_dtype`` (the
    port in float32 against the reference's bf16) has no bf16 products and
    breaks the energies bound; a dropped edge chunk loses products and
    breaks all three bounds; the untruncated rotation (the same values,
    the truncation being exact) does more products."""
    run = _eq_run(eq_setup, *ref, port=port, fault=fault)
    assert run["flops"] != run["want_flops"]
    r = _readings(run["e"], run["want_e"], run["loss"], run["want_loss"],
                  run["g"], run["wg"])
    ok = _within(r, EQ_BOUNDS)
    assert [k for k in ("out", "loss", "grad") if not ok[k]] == \
        list(broken), r
