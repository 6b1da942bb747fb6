"""Port parity: the LM serving path against the JAX reference on the CPU.

For the smoke configs of gemma2-9b (GQA, alternating local/global layers
with ring caches, softcaps), gemma-2b (MQA, embedding scaling; also with QK
norm) and qwen1.5-32b (MHA, QKV bias, untied head), the reference's
parameters are
carried over with ``params_from_numpy`` and the port's ``forward``,
``prefill`` and a 12-step ``decode_step`` sequence are held to the
reference's: logits, and every cache leaf after the prefill and after each
decode step.  The smoke configs are float32, so the tolerance is float32
noise from the two frameworks' summation orders through two layers:
atol 1e-5, rtol 1e-5 (the largest difference measured is 7.6e-6, on logits
up to 60 in magnitude; the reference's own decode-vs-forward oracle allows
2e-3).
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
from repro_torch.models.transformer import (LMConfig, TransformerLM,
                                            init_cache, init_params,
                                            params_from_numpy)

#: the three dense configs, and gemma-2b with QK norm (qwen3-moe's, the only
#: config that sets it, waits for moe_ffn)
ARCHS = ["gemma2-9b", "gemma-2b", "qwen1.5-32b", "gemma-2b+qk_norm"]
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


def test_moe_config_raises():
    cfg = LMConfig(name="moe-smoke", n_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=2, head_dim=16, d_ff=32, vocab_size=128,
                   n_experts=4, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="moe_ffn"):
        init_params(cfg, torch.Generator())
    dense = get_arch("gemma-2b").smoke_config()
    params = init_params(dense, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="moe_ffn"):
        TransformerLM(cfg, params)
