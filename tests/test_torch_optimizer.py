"""Port parity: AdamW and the gradient compressors against the JAX
reference on the CPU.

* ``train.optimizer``: ``init``'s tree, ``global_norm``, three ``update``
  steps (with warmup, weight decay, and a clipped step) against
  ``repro.train.optimizer`` on the same float32 and bfloat16 leaves, and
  the in-place update equal to the functional one bit for bit.  Tolerance
  1e-6 relative on the norm, 1e-5 on float32 parameters and moments after
  three steps (the frameworks' reductions and ``pow``, in the bias
  corrections, may differ in the last bits, and Adam divides by the small
  second moment), 1e-2 on bfloat16 parameters (one rounding).
* ``distributed.collectives``: ``quantize_int8``, ``dequantize_int8`` and
  ``compress_grads`` bit for bit against the reference's; the reference's
  error-feedback convergence test on the port; ``compressed_psum`` and
  ``reduce_scatter_grads`` on 4 gloo ranks against the reference's run
  under ``jax.vmap(..., axis_name=...)``, bit for bit (int8 payloads, an
  int32 sum, the same float32 operations).
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as M
from repro.distributed import collectives as jcoll
from repro.train import optimizer as jopt
from repro_torch.core import tree as ttree
from repro_torch.distributed import collectives as tcoll
from repro_torch.distributed.ranks import RankGroup
from repro_torch.train import optimizer as topt

TOL = dict(rtol=1e-6, atol=1e-9)


def _tree(seed=0):
    """A small parameter tree as numpy float32 arrays."""
    rng = np.random.default_rng(seed)
    return {"embed": rng.standard_normal((16, 8)).astype(np.float32),
            "final_norm": rng.standard_normal(8).astype(np.float32),
            "layers": {"wq": rng.standard_normal((2, 8, 8))
                       .astype(np.float32),
                       "ln": rng.standard_normal((2, 8)).astype(np.float32)}}


def _to_torch(tree, dtype=torch.float32):
    return ttree.tree_map(lambda a: torch.from_numpy(np.array(a))
                         .to(dtype), tree)


def _to_jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def test_tree_order_is_jax_order():
    tree = _tree()
    got = [tuple(x.shape) for x in ttree.tree_leaves(_to_torch(tree))]
    assert got == [x.shape for x in jax.tree.leaves(tree)]
    st = topt.init(_to_torch(tree))
    assert st.count.dtype == torch.int32 and st.count.dim() == 0
    assert len(ttree.tree_leaves(st)) == len(jax.tree.leaves(
        jopt.init(_to_jax(tree))))


def test_global_norm_matches_reference():
    tree = _tree(1)
    np.testing.assert_allclose(float(topt.global_norm(_to_torch(tree))),
                               float(jopt.global_norm(_to_jax(tree))),
                               **TOL)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("clip", (1.0, 1e3), ids=("clipped", "unclipped"))
def test_three_updates_match_reference(dtype, clip):
    cfg_kw = dict(lr=0.05, weight_decay=0.1, clip_norm=clip, warmup_steps=2)
    jcfg, tcfg = jopt.AdamWConfig(**cfg_kw), topt.AdamWConfig(**cfg_kw)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    base = _tree(2)
    jp, tp = _to_jax(base, jdt), _to_torch(base, tdt)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        g = _tree(10 + step)
        g = jax.tree.map(lambda a: a * 3.0, g)       # the norm clips at 1
        jp, js = jopt.update(jcfg, _to_jax(g, jdt), js, jp)
        tp, ts = topt.update(tcfg, _to_torch(g, tdt), ts, tp)
        assert int(ts.count) == int(js.count) == step + 1
        for a, b in zip(ttree.tree_leaves(tp), jax.tree.leaves(jp)):
            assert a.dtype == tdt
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5
                                       if dtype == "float32" else 1e-2,
                                       atol=1e-6 if dtype == "float32"
                                       else 1e-2)
        for a, b in zip(ttree.tree_leaves((ts.m, ts.v)),
                        jax.tree.leaves((js.m, js.v))):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-7)


def test_inplace_update_equals_functional():
    cfg = topt.AdamWConfig(lr=0.05, warmup_steps=1)
    p = _to_torch(_tree(3))
    s = topt.init(p)
    g = _to_torch(_tree(4))
    want_p, want_s = topt.update(cfg, g, s, p)
    keep = [x.clone() for x in ttree.tree_leaves((p, s.m, s.v))]
    for a, b in zip(ttree.tree_leaves((p, s.m, s.v)), keep):
        assert torch.equal(a, b)                # the functional form copies
    got_p, got_s = topt.update(cfg, g, s, p, inplace=True)
    for a, b, c in zip(ttree.tree_leaves((got_p, got_s.m, got_s.v)),
                       ttree.tree_leaves((want_p, want_s.m, want_s.v)),
                       ttree.tree_leaves((p, s.m, s.v))):
        assert torch.equal(a, b) and a.data_ptr() == c.data_ptr()


def test_quadratic_descent():
    """The reference's optimizer test on the port."""
    cfg = topt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1)
    params = {"x": torch.tensor([5.0, -3.0])}
    state = topt.init(params)
    for _ in range(200):
        x = params["x"].detach().requires_grad_()
        (g,) = torch.autograd.grad((x ** 2).sum(), (x,))
        params, state = topt.update(cfg, {"x": g}, state, params)
    assert float(params["x"].abs().max()) < 1e-2


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def test_quantize_and_compress_are_bit_equal():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(1000).astype(np.float32)
    jq, js = jcoll.quantize_int8(jnp.asarray(x))
    tq, ts = tcoll.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(
        tcoll.dequantize_int8(tq, ts).numpy(),
        np.asarray(jcoll.dequantize_int8(jq, js)))
    grads, res = _tree(5), _tree(6)
    jout = jcoll.compress_grads(_to_jax(grads), _to_jax(res))
    tout = tcoll.compress_grads(_to_torch(grads), _to_torch(res))
    for jt, tt in zip(jout, tout):
        for a, b in zip(ttree.tree_leaves(tt), jax.tree.leaves(jt)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    z = tcoll.init_residual(_to_torch(grads))
    assert all(t.dtype == torch.float32 and not t.any()
               for t in ttree.tree_leaves(z))


def test_error_feedback_convergence():
    """The reference's test: quadratic descent with int8 + error-feedback
    gradients lands near the float32 descent."""
    cfg = topt.AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=1)
    target = torch.linspace(-2, 2, 16)

    def run(compressed):
        params = {"x": torch.zeros(16)}
        state = topt.init(params)
        res = tcoll.init_residual(params)
        for _ in range(300):
            x = params["x"].detach().requires_grad_()
            (g,) = torch.autograd.grad(((x - target) ** 2).sum(), (x,))
            grads = {"x": g}
            if compressed:
                q, s, res = tcoll.compress_grads(grads, res)
                grads = ttree.tree_map(tcoll.dequantize_int8, q, s)
            params, state = topt.update(cfg, grads, state, params)
        return params["x"]

    x_fp, x_q = run(False), run(True)
    assert float((x_q - target).abs().max()) < 5e-2
    assert float((x_q - x_fp).abs().max()) < 5e-2


WORLD = 4


def grad_inputs():
    """Per rank a gradient tree and a residual (a leading dim the world
    divides, one it does not, a 0-d leaf)."""
    rng = np.random.default_rng(21)
    grads = [{"a": rng.standard_normal((8, 3)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32),
              "c": np.asarray(rng.standard_normal(), np.float32)}
             for _ in range(WORLD)]
    res = [{k: np.asarray(0.01 * rng.standard_normal(v.shape), np.float32)
            for k, v in g.items()} for g in grads]
    return grads, res


def test_collectives_on_gloo_ranks_match_vmap(tmp_path):
    grads, res = grad_inputs()
    with open(tmp_path / "job.pkl", "wb") as f:
        pickle.dump({"grads": grads, "res": res}, f)
    group = RankGroup(M.grad_rank, WORLD, (str(tmp_path),), deadline_s=120)
    group.wait()
    got = []
    for r in range(WORLD):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    assert all("error" not in g for g in got), [g.get("error") for g in got]

    def stacked(trees):
        return {k: jnp.asarray(np.stack([t[k] for t in trees]))
                for k in trees[0]}
    mean, new_res = jax.vmap(lambda g, r: jcoll.compressed_psum(g, r, "i"),
                             axis_name="i")(stacked(grads), stacked(res))
    rs = jax.vmap(lambda g: jcoll.reduce_scatter_grads(g, "i", WORLD),
                  axis_name="i")(stacked(grads))
    for r in range(WORLD):
        for k in grads[0]:
            np.testing.assert_array_equal(got[r]["mean"][k],
                                          np.asarray(mean[k][r]), err_msg=k)
            np.testing.assert_array_equal(got[r]["res"][k],
                                          np.asarray(new_res[k][r]),
                                          err_msg=k)
            np.testing.assert_allclose(got[r]["rs"][k],
                                       np.asarray(rs[k][r]), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
        assert got[r]["rs"]["a"].shape == (8 // WORLD, 3)
