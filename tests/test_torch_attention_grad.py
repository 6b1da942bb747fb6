"""Port parity: attention's gradients against the JAX reference on the CPU.

* ``flash_attention``'s gradients on CPU tensors (autograd of the port's
  ``attention_ref``) against ``jax.grad`` of the reference's
  ``attention_ref`` (the reference's train step differentiates its plain
  version: its Pallas kernel has no VJP), over the float32 rows of
  ``ATTN_CASES``, for a seeded output gradient;
* ``attention_bwd_ref`` (the plain version the card holds the backward
  kernel to, from the forward's output and row log-sum-exp) against both,
  and ``attention_lse_ref`` against ``jax.nn.logsumexp`` of the
  reference's masked scores;
* ``attention_chunked`` forward and gradient against the reference's
  (``tests/test_kernels.py``'s cases and block sizes).

Tolerances: 2e-5 on the outputs, as the reference's own float32 attention
tests (the frameworks sum the dot products in other orders); 1e-4 on the
gradients, as ``tests/test_kernels.py``'s chunked-gradient test, whose
sums run over the keys and the group's query heads as well.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.chunked import \
    attention_chunked as jattention_chunked
from repro.kernels.flash_attention.ref import attention_ref as jattention_ref
from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                 attention_chunked,
                                                 attention_lse_ref,
                                                 attention_ref,
                                                 flash_attention)
from test_torch_gpu import ATTN_CASES

F32_CASES = [c for c in ATTN_CASES if c[9] == "float32"]
OUT_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(case, seed=0):
    """(numpy q, k, v, dO) of a case, float32."""
    B, Hq, Hkv, Sq, Skv, D = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D),
                      (B, Hq, Sq, D))]


def _kw(case):
    *_, causal, window, softcap, _, extra = case
    return dict(causal=causal, window=window, softcap=softcap, **extra)


def _jax_grads(fn, q, k, v, do, kw):
    """(output, dq, dk, dv) of the reference's ``fn`` by ``jax.vjp``."""
    out, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, **kw),
                       *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _torch_grads(fn, q, k, v, do, kw):
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fn(*ts, **kw)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(do))
    return [out.detach().numpy()] + [g.numpy() for g in grads]


@pytest.mark.parametrize("case", F32_CASES,
                         ids=[f"attn{i}" for i in range(len(F32_CASES))])
def test_flash_attention_grads_match_jax(case):
    q, k, v, do = _inputs(case)
    kw = _kw(case)
    want = _jax_grads(jattention_ref, q, k, v, do, kw)
    got = _torch_grads(flash_attention, q, k, v, do, kw)
    np.testing.assert_allclose(got[0], want[0], **OUT_TOL)
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("case", F32_CASES,
                         ids=[f"attn{i}" for i in range(len(F32_CASES))])
def test_attention_bwd_ref_matches_autograd_and_jax(case):
    q, k, v, do = _inputs(case, seed=1)
    kw = _kw(case)
    want = _jax_grads(jattention_ref, q, k, v, do, kw)
    auto = _torch_grads(attention_ref, q, k, v, do, kw)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o = attention_ref(tq, tk, tv, **kw)
    lse = attention_lse_ref(tq, tk, **kw)
    got = [g.numpy() for g in attention_bwd_ref(tq, tk, tv, o, lse, tdo,
                                                **kw)]
    for name, g, a, w in zip(("dq", "dk", "dv"), got, auto[1:], want[1:]):
        assert g.dtype == np.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g, a, **GRAD_TOL, err_msg=name)
        np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("case", F32_CASES,
                         ids=[f"attn{i}" for i in range(len(F32_CASES))])
def test_attention_lse_ref_matches_jax(case):
    """The row log-sum-exp of the reference's masked, scaled, softcapped
    scores; a row with no visible key is +inf (the reference's is -inf
    there: the backward's P = exp(x - lse) must be 0)."""
    q, k, _, _ = _inputs(case, seed=2)
    B, Hq, Hkv, Sq, Skv, D = case[:6]
    kw = _kw(case)
    sm = kw.get("sm_scale", D ** -0.5)
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q),
                   jnp.repeat(jnp.asarray(k), Hq // Hkv, axis=1)) * sm
    if kw["softcap"] > 0:
        s = kw["softcap"] * jnp.tanh(s / kw["softcap"])
    qi, kj = np.arange(Sq)[:, None], np.arange(Skv)[None, :]
    mask = kj < kw.get("kv_len", Skv)
    if kw["causal"]:
        mask = mask & (qi >= kj)
    if kw["window"] > 0:
        mask = mask & (qi - kj < kw["window"])
    want = np.asarray(jax.nn.logsumexp(jnp.where(mask, s, -jnp.inf),
                                       axis=-1))
    want = np.where(mask.any(-1), want, np.inf)
    got = attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k),
                            **kw).numpy()
    np.testing.assert_allclose(got, want, **OUT_TOL)


def test_attention_ref_without_grad_is_unchanged():
    """The in-place path (no autograd) and the out-of-place one give the
    same output bits."""
    case = F32_CASES[7]
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(case))
    kw = _kw(case)
    with torch.no_grad():
        a = attention_ref(q, k, v, **kw)
    b = attention_ref(q.requires_grad_(), k, v, **kw)
    assert b.requires_grad and torch.equal(a, b.detach())


# the reference's chunked cases (tests/test_kernels.py), each block size
CHUNKED_CASES = [
    (1, 4, 2, 256, 256, 64, True, 0, 0.0),
    (2, 4, 1, 128, 256, 64, False, 0, 0.0),
    (1, 2, 2, 256, 256, 32, True, 64, 30.0),
    (1, 8, 8, 128, 128, 128, True, 0, 50.0),
]


@pytest.mark.parametrize("block_k", (64, 128))
@pytest.mark.parametrize("case", CHUNKED_CASES,
                         ids=[f"chunked{i}" for i in range(len(CHUNKED_CASES))])
def test_chunked_matches_reference(case, block_k):
    B, Hq, Hkv, Sq, Skv, D, causal, window, cap = case
    rng = np.random.default_rng(10)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D)))
    do = rng.standard_normal((B, Hq, Sq, D)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=cap, block_k=block_k)
    want = _jax_grads(jattention_chunked, q, k, v, do, kw)
    got = _torch_grads(attention_chunked, q, k, v, do, kw)
    np.testing.assert_allclose(got[0], want[0], **OUT_TOL)
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=name)
    # and the port's chunked schedule against its own dense attention
    dense = attention_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                          causal=causal, window=window, softcap=cap)
    np.testing.assert_allclose(got[0], dense.numpy(), **OUT_TOL)


def test_chunked_rejects_a_block_that_does_not_divide():
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 128, 32))
                                .astype(np.float32)) for _ in range(3))
    with pytest.raises(ValueError, match="does not divide"):
        attention_chunked(q, k, v, block_k=48)
