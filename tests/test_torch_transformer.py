"""Port parity: the LM serving path against the JAX reference on the CPU.

For the smoke configs of gemma2-9b (GQA, alternating local/global layers
with ring caches, softcaps), gemma-2b (MQA, embedding scaling; also with QK
norm), qwen1.5-32b (MHA, QKV bias, untied head), phi3.5-moe (16 experts
top-2 at smoke size 4 top-2) and qwen3-moe (QK norm, 8 experts top-2 at
smoke size), the reference's
parameters are
carried over with ``params_from_numpy`` and the port's ``forward``,
``prefill`` and a 12-step ``decode_step`` sequence are held to the
reference's: logits, and every cache leaf after the prefill and after each
decode step.  The smoke configs are float32, so the tolerance is float32
noise from the two frameworks' summation orders through two layers:
atol 1e-5, rtol 1e-5 (the largest difference measured is 7.6e-6, on logits
up to 60 in magnitude; the reference's own decode-vs-forward oracle allows
2e-3).  ``moe_ffn`` is held on its own at a capacity that drops and one
that does not, ungrouped and in two dispatch groups, with the same
tolerance and its kept / dropped assignments bit-equal to the reference's
routing.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.data.synth import lm_batches as jlm_batches
from repro.models import transformer as jtfm
from repro_torch.configs import get_arch
from repro_torch.data.synth import lm_batches
from repro_torch.launch.steps import build_lm_decode_step, \
    build_lm_prefill_step
from repro_torch.models import transformer as ttfm
from repro_torch.models.transformer import (TransformerLM, init_cache,
                                            init_params, params_from_numpy)

#: the three dense configs, gemma-2b with QK norm, and the two MoE configs
ARCHS = ["gemma2-9b", "gemma-2b", "qwen1.5-32b", "gemma-2b+qk_norm",
         "phi3.5-moe-42b-a6.6b", "qwen3-moe-30b-a3b"]
MOE_ARCHS = ["phi3.5-moe-42b-a6.6b", "qwen3-moe-30b-a3b"]
TOL = dict(atol=1e-5, rtol=1e-5)
B, S = 2, 12


def close(got, want, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL,
                               err_msg=what)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(reference config, reference params, port model, tokens)."""
    arch, _, flag = request.param.partition("+")
    jcfg = jget_arch(arch).smoke_config()
    cfg = get_arch(arch).smoke_config()
    if flag:
        jcfg = dataclasses.replace(jcfg, **{flag: True})
        cfg = dataclasses.replace(cfg, **{flag: True})
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, jparams)
    model = TransformerLM(cfg, params_from_numpy(tree, cfg, "cpu"))
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S)) \
        .astype(np.int32)
    return jcfg, jparams, model, toks


def test_forward_matches_reference(pair):
    jcfg, jparams, model, toks = pair
    want = jtfm.forward(jparams, jnp.asarray(toks), jcfg)
    got = model(torch.from_numpy(toks))
    assert got.shape == (B, S, jcfg.vocab_size)
    close(got, want, "forward logits")


def test_prefill_matches_reference(pair):
    jcfg, jparams, model, toks = pair
    want_logits, want_cache = jtfm.prefill(jparams, jnp.asarray(toks), jcfg)
    got_logits, got_cache = build_lm_prefill_step(model.cfg)(
        model, torch.from_numpy(toks))
    assert got_logits.dtype == torch.float32
    close(got_logits, want_logits, "prefill logits")
    assert sorted(got_cache) == sorted(want_cache)
    for name in want_cache:
        assert tuple(got_cache[name].shape) == want_cache[name].shape, name
        close(got_cache[name], want_cache[name], f"prefill cache {name}")


def test_decode_sequence_matches_reference(pair):
    jcfg, jparams, model, toks = pair
    jcache = jtfm.init_cache(jcfg, B, S, jnp.float32)
    cache = init_cache(model.cfg, B, S, torch.float32, device="cpu")
    jstep = jax.jit(lambda c, t, p: jtfm.decode_step(jparams, c, t, p, jcfg))
    step = build_lm_decode_step(model.cfg)
    for t in range(S):
        want, jcache = jstep(jcache, jnp.asarray(toks[:, t]), jnp.asarray(t))
        got, cache = step(model, cache, torch.from_numpy(toks[:, t]), t)
        close(got, want, f"decode logits, step {t}")
        assert sorted(cache) == sorted(jcache)
        for name in jcache:
            close(cache[name], jcache[name], f"cache {name}, step {t}")


def test_decode_after_prefill_matches_forward(pair):
    """The port alone: prefill 8 tokens, seed a 12-slot cache with them and
    decode the other 4; the logits are forward's at those positions (the
    ring of gemma2's local layers wraps)."""
    _, _, model, toks = pair
    cfg, t = model.cfg, torch.from_numpy(toks)
    full = model(t)
    logits, pc = model.prefill(t[:, :8])
    close(logits, full[:, 7].numpy(), "prefill vs forward")
    cache = init_cache(cfg, B, S, torch.float32, device="cpu")
    cache["k"][:, :, :, :8] = pc["k"]
    cache["v"][:, :, :, :8] = pc["v"]
    if cfg.has_local:
        cache["k_local"].copy_(pc["k_local"])
        cache["v_local"].copy_(pc["v_local"])
    for pos in range(8, S):
        logits, cache = model.decode_step(cache, t[:, pos], pos)
        close(logits, full[:, pos].numpy(), f"decode at {pos} vs forward")


def test_params_from_numpy_keeps_bfloat16():
    """A bfloat16 reference tree (numpy's bfloat16 from ml_dtypes) carries
    over value for value."""
    jcfg = jget_arch("gemma2-9b").smoke_config()
    tree = jax.tree.map(np.asarray, jtfm.init_params(
        jcfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16))
    cfg = get_arch("gemma2-9b").smoke_config()
    params = params_from_numpy(tree, cfg, "cpu")
    got = params["layers"]["wq"]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(),
                          tree["layers"]["wq"].astype(np.float32))
    as_f32 = params_from_numpy(tree, cfg, "cpu", dtype=torch.float32)
    assert as_f32["embed"].dtype == torch.float32


def test_lm_batches_match_reference():
    """One seed gives the same tokens and labels in both packages."""
    for got, want in zip(zip(range(2), lm_batches(256000, 2, 64, seed=3)),
                         jlm_batches(256000, 2, 64, seed=3)):
        for a, b in zip(got[1], want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the MoE FFN on its own
# ---------------------------------------------------------------------------

def _ref_keep(x, router, jcfg):
    """The reference's kept assignments per group, (G, Tg * K) in (token,
    choice) order: ``moe_ffn``'s routing lines (its capacity, top-k,
    stable sort and ranks), which it does not return."""
    G = jcfg.dispatch_groups
    T, D = x.shape
    E, K, Tg = jcfg.n_experts, jcfg.top_k, T // G
    C = max(8, min(int(np.ceil(Tg * K / E * jcfg.capacity_factor)), Tg))
    gates = jax.nn.softmax((jnp.asarray(x).reshape(G, Tg, D)
                            @ jnp.asarray(router)).astype(jnp.float32), -1)
    _, top_e = jax.lax.top_k(gates, K)
    flat_e = top_e.reshape(G, Tg * K)
    order = jnp.argsort(flat_e, axis=-1, stable=True)
    se = jnp.take_along_axis(flat_e, order, axis=-1)
    idx = jnp.broadcast_to(jnp.arange(Tg * K)[None], (G, Tg * K))
    run_start = jnp.concatenate(
        [jnp.ones((G, 1), bool), se[:, 1:] != se[:, :-1]], axis=1)
    base = jax.lax.cummax(jnp.where(run_start, idx, -1), axis=1)
    keep_sorted = np.asarray(idx - base < C)
    keep = np.zeros_like(keep_sorted)
    np.put_along_axis(keep, np.asarray(order), keep_sorted, axis=1)
    return keep, np.asarray(top_e), C


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("capacity_factor", [1.0, 8.0],
                         ids=["drops", "keeps_all"])
def test_moe_ffn_matches_reference(arch, groups, capacity_factor):
    """64 tokens through one layer's experts: the output within TOL, the
    experts chosen and the kept assignments bit-equal to the reference's
    routing; at capacity factor 1.0 some assignments drop, at 8.0 none."""
    jcfg = dataclasses.replace(jget_arch(arch).smoke_config(),
                               capacity_factor=capacity_factor,
                               dispatch_groups=groups)
    cfg = dataclasses.replace(get_arch(arch).smoke_config(),
                              capacity_factor=capacity_factor,
                              dispatch_groups=groups)
    tree = jax.tree.map(np.asarray,
                        jtfm.init_params(jcfg, jax.random.PRNGKey(7)))
    lw = {k: tree["layers"][k][1] for k in ("router", "w_gate", "w_up",
                                            "w_down")}
    x = np.random.default_rng(2).standard_normal((64, cfg.d_model)) \
        .astype(np.float32)
    want = jtfm.moe_ffn(jnp.asarray(x),
                        {k: jnp.asarray(v) for k, v in lw.items()}, jcfg)
    tlw = {k: torch.from_numpy(v.copy()) for k, v in lw.items()}
    got = ttfm.moe_ffn(torch.from_numpy(x), tlw, cfg)
    close(got, want, "moe_ffn")
    route = ttfm.moe_route(torch.from_numpy(x).reshape(groups, 64 // groups,
                                                       -1),
                           tlw["router"], cfg)
    keep, top_e, C = _ref_keep(x, lw["router"], jcfg)
    assert route.capacity == C
    assert np.array_equal(route.top_e.numpy(), top_e)
    got_keep = route.keep.reshape(groups, -1).numpy()
    assert np.array_equal(got_keep, keep)
    assert (not keep.all()) == (capacity_factor == 1.0)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_init_params_match_reference_shapes(arch):
    """The MoE leaves (the router and the expert-stacked FFN, drawn a layer
    at a time) have the reference's names, shapes and dtypes and their
    scales: the router's d_model ** -0.5, the experts' fan-in ** -0.5."""
    jcfg = jget_arch(arch).smoke_config()
    cfg = get_arch(arch).smoke_config()
    want = jax.tree.map(np.asarray,
                        jtfm.init_params(jcfg, jax.random.PRNGKey(0)))
    got = init_params(cfg, torch.Generator().manual_seed(0))
    assert sorted(got["layers"]) == sorted(want["layers"])
    assert sorted(k for k in got if k != "layers") == \
        sorted(k for k in want if k != "layers")
    for name, w in want["layers"].items():
        t = got["layers"][name]
        assert tuple(t.shape) == w.shape and t.dtype == torch.float32, name
    D, F = cfg.d_model, cfg.d_ff
    for name, scale in (("router", D ** -0.5), ("w_gate", D ** -0.5),
                        ("w_down", F ** -0.5)):
        std = float(got["layers"][name].std())
        assert abs(std / scale - 1) < 0.15, (name, std, scale)
    # each layer's experts are their own draw
    assert not torch.equal(got["layers"]["w_up"][0], got["layers"]["w_up"][1])


def test_moe_top_k_breaks_ties_to_the_lower_expert():
    """Tied gates choose the lower expert first, as ``jax.lax.top_k``."""
    cfg = get_arch("qwen3-moe-30b-a3b").smoke_config()
    E, D = cfg.n_experts, cfg.d_model
    router = np.zeros((D, E), np.float32)
    router[0, [1, 6]] = 1.0               # experts 1 and 6 tie on top
    router[0, [0, 3, 5]] = 0.5            # then 0, 3 and 5 tie
    x = np.zeros((16, D), np.float32)
    x[:, 0] = np.linspace(0.5, 2.0, 16)
    route = ttfm.moe_route(torch.from_numpy(x)[None],
                           torch.from_numpy(router), cfg)
    _, want = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x @ router), -1),
                            cfg.top_k)
    assert np.array_equal(route.top_e[0].numpy(), np.asarray(want))
    assert route.top_e[0, 0].tolist() == [1, 6]


@pytest.mark.parametrize("n_tokens", [1, 2, 7, 64, 1000, 16384])
def test_moe_capacity_matches_reference(n_tokens):
    """C = max(8, min(ceil(T * K / E * cf), T)) for qwen3-moe's full
    config, as the reference computes it inside ``moe_ffn``."""
    cfg = get_arch("qwen3-moe-30b-a3b").full_config()
    want = int(np.ceil(n_tokens * cfg.top_k / cfg.n_experts
                       * cfg.capacity_factor))
    assert ttfm.moe_capacity(n_tokens, cfg) == max(8, min(want, n_tokens))
