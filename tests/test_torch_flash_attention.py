"""Port parity: the flash-attention family against the JAX reference on the
CPU.

The port's plain version (``attention_ref``, which the op runs for CPU
tensors) is held to the reference's Pallas kernel in interpret mode and to
its dense oracle, on every case of ``tests/test_kernels.py``'s sweep plus a
``kv_len`` bound, ``Sq != Skv``, head_dim 256, an explicit ``sm_scale`` and
rows with no visible key, each in float32 and bfloat16, plus the served
shapes of qwen1.5-32b and gemma-2b and a ragged tile (the cases of the card
test, ``ATTN_CASES``, which imports no JAX).  Tolerances are the reference
test's: 2e-5 in float32 (the two frameworks sum the dot products in another
order) and 2e-2 in bfloat16 (one rounding of the output).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref as jattention_ref
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from test_torch_gpu import ATTN_CASES

BF16 = "bfloat16"
JAX_DTYPES = {"float32": jnp.float32, BF16: jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, BF16: torch.bfloat16}


def _inputs(case, seed):
    B, Hq, Hkv, Sq, Skv, D, *_, dtype, _ = case
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))]
    return ([jnp.asarray(a, JAX_DTYPES[dtype]) for a in arrays],
            [torch.from_numpy(a).to(TORCH_DTYPES[dtype]) for a in arrays])


def _block(n):
    """The reference kernel's tile along an axis of n: 64, or the whole
    axis when 64 does not divide it (it takes no ragged tile)."""
    return 64 if n % 64 == 0 else n


@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=[f"attn{i}" for i in range(len(ATTN_CASES))])
def test_attention_matches_reference(case):
    *_, causal, window, softcap, dtype, extra = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(case, seed=0)
    kw = dict(causal=causal, window=window, softcap=softcap, **extra)
    got = flash_attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert torch.equal(got, attention_ref(tq, tk, tv, **kw))
    tol = 2e-2 if dtype == BF16 else 2e-5
    Sq, Skv = case[3], case[4]
    for want in (jflash(jq, jk, jv, block_q=_block(Sq), block_k=_block(Skv),
                        interpret=True, **kw),
                 jattention_ref(jq, jk, jv, **kw)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)
    if extra.get("kv_len") == 0:
        assert not got.any()


def test_attention_impl_follows_the_tensors():
    """On CPU tensors ``impl='cuda'`` raises: the op never moves data."""
    _, (tq, tk, tv) = _inputs(ATTN_CASES[0], seed=1)
    with pytest.raises(ValueError):
        flash_attention(tq, tk, tv, impl="cuda")
    assert torch.equal(flash_attention(tq, tk, tv, impl="torch"),
                       attention_ref(tq, tk, tv))
