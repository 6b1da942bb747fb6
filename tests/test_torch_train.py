"""Port parity: training against the JAX reference on the CPU.

* ``loss_fn`` and every gradient leaf against
  ``jax.value_and_grad(repro.models.transformer.loss_fn)`` for the five LM
  smoke configs in float32, with ``attn_impl`` "ref" and "chunked": atol
  1e-5 / rtol 1e-4 on the loss (of order 5 to 60) and the gradients (two
  frameworks' float32 summation orders through two layers, a softmax over
  the vocabulary and the attention's sums; measured below 4e-6 and 3e-7).
* Two train steps (``build_lm_train_step``, AdamW) with 1 and 2
  microbatches against the reference's: loss, parameters and moments
  within atol 1e-5 / rtol 1e-4 (Adam divides by the small second moment,
  so a gradient's last bits move an early step's update relatively more);
  remat off, "full" and "dots" give the same loss and gradients bit for
  bit.
* ``train.loop.train``: the reference's preemption/resume equivalence on
  the port, an LM smoke run preempted and resumed bit for bit, and a
  ``(params, opt_state)`` checkpoint of either package restored by the
  other leaf for leaf.
* MIND's ``train_loss`` gradients against ``jax.grad`` of the reference's,
  ``neg_groups`` 1 and 2, atol 1e-6 / rtol 1e-4.
* ``python -m repro_torch.launch.train --device cpu`` for gemma-2b and
  MIND: a few steps and a resume from the checkpoint.
"""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_arch as jget_arch
from repro.launch import steps as jsteps
from repro.models import transformer as jtfm
from repro.models.recsys import mind as jmind
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import get_arch
from repro_torch.core import tree as ttree
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as ttfm
from repro_torch.models.recsys import mind as tmind
from repro_torch.models.transformer import params_from_numpy
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt

ARCHS = ["gemma2-9b", "gemma-2b", "qwen1.5-32b", "phi3.5-moe-42b-a6.6b",
         "qwen3-moe-30b-a3b"]
TOL = dict(atol=1e-5, rtol=1e-4)
B, S = 2, 16


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _setup(arch, seed=3):
    """(reference config, reference params, port config, port params,
    tokens, labels) of an arch's smoke config, float32."""
    jcfg = jget_arch(arch).smoke_config()
    cfg = get_arch(arch).smoke_config()
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, jp, cfg, tp, toks, labels


def _assert_trees_close(got, want, what, **tol):
    g, w = ttree.tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert tuple(a.shape) == b.shape, (what, i)
        np.testing.assert_allclose(_np(a), _np(b), **(tol or TOL),
                                   err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("attn_impl", ["ref", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, attn_impl):
    jcfg, jp, cfg, tp, toks, labels = _setup(arch)
    want, jg = jax.value_and_grad(jtfm.loss_fn)(
        jp, jnp.asarray(toks), jnp.asarray(labels), jcfg,
        attn_impl=attn_impl)
    got, g = tsteps.value_and_grad(
        lambda p, t, l: ttfm.loss_fn(p, t, l, cfg, attn_impl=attn_impl),
        tp, torch.from_numpy(toks), torch.from_numpy(labels))
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), **TOL)
    _assert_trees_close(g, jg, "grads")


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", ["gemma2-9b", "gemma-2b",
                                  "qwen3-moe-30b-a3b"])
def test_train_steps_match_reference(arch, n_micro):
    jcfg, jp, cfg, tp, toks, labels = _setup(arch)
    jstep = jsteps.build_lm_train_step(jcfg, n_microbatches=n_micro)
    tstep = tsteps.build_lm_train_step(cfg, n_microbatches=n_micro)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(2):
        t, l = (toks + i) % cfg.vocab_size, labels
        jp, js, jl = jstep(jp, js, jnp.asarray(t), jnp.asarray(l))
        tp, ts, tl = tstep(tp, ts, torch.from_numpy(t), torch.from_numpy(l))
        np.testing.assert_allclose(float(tl), float(jl), **TOL)
        _assert_trees_close(tp, jp, f"params after step {i + 1}")
        _assert_trees_close((ts.m, ts.v), (js.m, js.v),
                            f"moments after step {i + 1}")
        assert int(ts.count) == int(js.count) == i + 1


def _rel_errs(got, want):
    """Per leaf, ||got - want|| / ||want|| (Frobenius, float32)."""
    return [np.linalg.norm(_np(a) - _np(b)) / np.linalg.norm(_np(b))
            for a, b in zip(got, want)]


def test_bf16_params_accumulate_microbatches_in_float32():
    """bfloat16 parameters: each microbatch's gradient in bfloat16, their
    sum in float32 divided once, as the reference's scan.  The port's sum
    is held to ``jax.grad`` of each bfloat16 microbatch in the reference,
    summed in float32 and divided once: each leaf within 1e-3 relative
    (Frobenius; measured below 2.2e-4, the bfloat16 rounding of two
    frameworks' float32 gradients), which a dropped microbatch, a zeroed
    one or a sum left undivided (each 0.5 or more) fails; the test checks
    that they do.  The step's float32 moments are held to the reference's
    jitted step within 1e-2 relative (measured 1.5e-3 for m and 3.3e-3 for
    v: the jitted scan rounds some bfloat16 gradients the other way), the
    loss within rtol 1e-5."""
    jcfg, jp, cfg, tp, toks, labels = _setup("gemma-2b")
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tp = ttree.tree_map(lambda t: t.to(torch.bfloat16), tp)
    t, l = torch.from_numpy(toks), torch.from_numpy(labels)
    _, grads = tsteps.lm_value_and_grad(cfg, tp, t, l, n_microbatches=2)
    parts = [tsteps.lm_value_and_grad(cfg, tp, t[i:i + 1], l[i:i + 1])[1]
             for i in range(2)]
    for g, a, b in zip(ttree.tree_leaves(grads), ttree.tree_leaves(parts[0]),
                       ttree.tree_leaves(parts[1])):
        assert g.dtype == torch.float32 and a.dtype == torch.bfloat16
        assert torch.equal(g, (a.float() + b.float()) / 2)
    jparts = [[np.asarray(x, np.float32) for x in jax.tree.leaves(
        jax.grad(jtfm.loss_fn)(jp, jnp.asarray(toks[i:i + 1]),
                               jnp.asarray(labels[i:i + 1]), jcfg))]
        for i in range(2)]
    want = [(a + b) / 2 for a, b in zip(*jparts)]
    assert max(_rel_errs(ttree.tree_leaves(grads), want)) < 1e-3
    for fault in ([a / 2 for a in jparts[0]], [b / 2 for b in jparts[1]],
                  [a + b for a, b in zip(*jparts)]):
        assert min(_rel_errs(fault, want)) > 1e-3
    jstep = jsteps.build_lm_train_step(jcfg, n_microbatches=2)
    jp2, js, jl = jstep(jp, jopt.init(jp), jnp.asarray(toks),
                        jnp.asarray(labels))
    tp2, ts, tl = tsteps.build_lm_train_step(cfg, n_microbatches=2)(
        tp, topt.init(tp), t, l)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for got, ref in ((ts.m, js.m), (ts.v, js.v)):
        assert max(_rel_errs(ttree.tree_leaves(got),
                             jax.tree.leaves(ref))) < 1e-2
    _assert_trees_close(tp2, jp2, "bf16 params", atol=1e-2, rtol=1e-2)


def test_donated_step_equals_the_functional_step():
    _, _, cfg, tp, toks, labels = _setup("gemma-2b")
    t, l = torch.from_numpy(toks), torch.from_numpy(labels)
    want_p, want_s, want_l = tsteps.build_lm_train_step(
        cfg, n_microbatches=2)(tp, topt.init(tp), t, l)
    p = ttree.tree_map(torch.clone, tp)
    got_p, got_s, got_l = tsteps.build_lm_train_step(
        cfg, n_microbatches=2, donate=True)(p, topt.init(p), t, l)
    assert torch.equal(got_l, want_l)
    for a, b in zip(ttree.tree_leaves((got_p, got_s)),
                    ttree.tree_leaves((want_p, want_s))):
        assert torch.equal(a, b)
    assert all(a.data_ptr() == b.data_ptr() for a, b in
               zip(ttree.tree_leaves(got_p), ttree.tree_leaves(p)))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_are_bit_equal(arch):
    _, _, cfg, tp, toks, labels = _setup(arch)
    out = {}
    for name, kw in (("off", dict(remat=False)),
                     ("full", dict(remat=True, remat_policy="full")),
                     ("dots", dict(remat=True, remat_policy="dots"))):
        c = dataclasses.replace(cfg, **kw)
        out[name] = tsteps.value_and_grad(
            lambda p, t, l: ttfm.loss_fn(p, t, l, c), tp,
            torch.from_numpy(toks), torch.from_numpy(labels))
    for name in ("full", "dots"):
        assert torch.equal(out[name][0], out["off"][0]), name
        for a, b in zip(ttree.tree_leaves(out[name][1]),
                        ttree.tree_leaves(out["off"][1])):
            assert torch.equal(a, b), name


def test_unknown_attn_impl_or_remat_policy_raises():
    _, _, cfg, tp, toks, _ = _setup("gemma2-9b")
    t = torch.from_numpy(toks)
    with pytest.raises(ValueError, match="attn_impl"):
        ttfm.forward(tp, t, cfg, attn_impl="pallas2")
    with pytest.raises(ValueError, match="remat_policy"):
        ttfm.forward(tp, t, dataclasses.replace(cfg, remat_policy="most"))


def test_forward_matches_the_serving_model():
    """The functional forward and ``TransformerLM`` give the same logits;
    the serving model records no autograd."""
    _, _, cfg, tp, toks, _ = _setup("gemma2-9b")
    t = torch.from_numpy(toks)
    model = ttfm.TransformerLM(cfg, tp)
    with torch.no_grad():
        want = ttfm.forward(tp, t, cfg)
    got = model(t)
    assert got.grad_fn is None and torch.equal(got, want)
    logits, cache = model.prefill(t)
    assert logits.grad_fn is None
    assert all(c.grad_fn is None for c in cache.values())


# ---------------------------------------------------------------------------
# the loop and checkpoints
# ---------------------------------------------------------------------------

def test_preemption_resume_equivalence(tmp_path):
    """The reference's test (tests/test_substrate.py) on the port: 20 steps
    straight == preempted at 13 and restarted from the step-10
    checkpoint."""
    cfg = topt.AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=1)

    def step(p, s, x, y):
        value, g = tsteps.value_and_grad(
            lambda pp, a, b: ((a @ pp["w"] - b) ** 2).mean(), p, x, y)
        p2, s2 = topt.update(cfg, g, s, p)
        return p2, s2, value

    def data():
        rng = np.random.default_rng(0)
        while True:
            x = rng.standard_normal((8, 4)).astype(np.float32)
            yield (torch.from_numpy(x),
                   torch.from_numpy(x @ np.arange(4.0, dtype=np.float32)))

    p0 = {"w": torch.zeros(4)}
    s0 = topt.init(p0)
    quiet = dict(log=lambda *a: None)
    r1 = tloop.train(step, p0, s0, data(), ckpt_dir=tmp_path / "a",
                     max_steps=20, ckpt_every=5, **quiet)
    with pytest.raises(tloop.Preempted):
        tloop.train(step, p0, s0, data(), ckpt_dir=tmp_path / "b",
                    max_steps=20, ckpt_every=5, preempt_at=13, **quiet)
    r2 = tloop.train(step, p0, s0, data(), ckpt_dir=tmp_path / "b",
                     max_steps=20, ckpt_every=5, **quiet)
    assert torch.equal(r1["params"]["w"], r2["params"]["w"])
    assert r1["losses"][10:] == r2["losses"]


def test_lm_resume_is_bit_equal(tmp_path):
    _, _, cfg, tp, _, _ = _setup("gemma2-9b")
    step = tsteps.build_lm_train_step(cfg, n_microbatches=2)

    def data():
        rng = np.random.default_rng(1)
        while True:
            t = rng.integers(0, cfg.vocab_size, (B, S + 1))
            yield (torch.from_numpy(t[:, :-1]),
                   torch.from_numpy(t[:, 1:]))

    quiet = dict(log=lambda *a: None)
    r1 = tloop.train(step, tp, topt.init(tp), data(),
                     ckpt_dir=tmp_path / "a", max_steps=5, ckpt_every=2,
                     **quiet)
    with pytest.raises(tloop.Preempted):
        tloop.train(step, tp, topt.init(tp), data(), ckpt_dir=tmp_path / "b",
                    max_steps=5, ckpt_every=2, preempt_at=3, **quiet)
    r2 = tloop.train(step, tp, topt.init(tp), data(),
                     ckpt_dir=tmp_path / "b", max_steps=5, ckpt_every=2,
                     **quiet)
    for a, b in zip(ttree.tree_leaves((r1["params"], r1["opt_state"])),
                    ttree.tree_leaves((r2["params"], r2["opt_state"]))):
        assert torch.equal(a, b)


def test_train_checkpoints_restore_across_packages(tmp_path):
    """A ``(params, opt_state)`` checkpoint of the reference's loop restores
    in the port's, and the port's in the reference's, leaf for leaf."""
    jcfg, jp, cfg, tp, toks, labels = _setup("qwen1.5-32b")
    jstep = jsteps.build_lm_train_step(jcfg)
    jp2, js2, _ = jstep(jp, jopt.init(jp), jnp.asarray(toks),
                        jnp.asarray(labels))
    jckpt.save(tmp_path / "ref", 1, (jp2, js2), extra={"loss": 1.0})
    (rp, rs), extra = tckpt.restore(tmp_path / "ref", (tp, topt.init(tp)),
                                    device="cpu")
    assert extra["loss"] == 1.0 and isinstance(rs, topt.AdamWState)
    assert rs.count.dtype == torch.int32 and int(rs.count) == 1
    for a, b in zip(ttree.tree_leaves((rp, rs)), jax.tree.leaves((jp2, js2))):
        np.testing.assert_array_equal(_np(a), _np(b))

    tstep = tsteps.build_lm_train_step(cfg)
    tp2, ts2, _ = tstep(tp, topt.init(tp), torch.from_numpy(toks),
                        torch.from_numpy(labels))
    tckpt.save(tmp_path / "port", 1, (tp2, ts2))
    (qp, qs), _ = jckpt.restore(tmp_path / "port", (jp, jopt.init(jp)))
    assert qs.count.dtype == jnp.int32
    for a, b in zip(jax.tree.leaves((qp, qs)), ttree.tree_leaves((tp2, ts2))):
        assert a.dtype == jnp.dtype(str(b.dtype).replace("torch.", ""))
        np.testing.assert_array_equal(_np(a), _np(b))


def test_reference_loop_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's loop runs 4 steps of its MIND trainer and
    checkpoints; the port's loop resumes there and its 4 more steps equal
    the reference's within the train-step tolerance."""
    jcfg = jget_arch("mind").smoke_config()
    cfg = get_arch("mind").smoke_config()
    jp = jmind.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tmind.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")

    def jstep(p, s, h, m, t):
        value, g = jax.value_and_grad(jmind.train_loss)(p, h, m, t, jcfg)
        p2, s2 = jopt.update(jsteps.ADAMW, g, s, p)
        return p2, s2, value

    def data(to):
        rng = np.random.default_rng(4)
        while True:
            h = rng.integers(0, cfg.n_items, (8, cfg.hist_len))
            m = (rng.random((8, cfg.hist_len)) < 0.7).astype(np.float32)
            t = rng.integers(0, cfg.n_items, 8)
            yield tuple(to(np.asarray(x, np.int32 if x.dtype.kind == "i"
                                      else np.float32)) for x in (h, m, t))

    quiet = dict(log=lambda *a: None)
    jr = jloop.train(jstep, jp, jopt.init(jp), data(jnp.asarray),
                     ckpt_dir=tmp_path / "j", max_steps=8, ckpt_every=4,
                     **quiet)
    # the reference's step-4 checkpoint, alone, resumed by the port
    jckpt.save(tmp_path / "t", 4,
               jckpt.restore(tmp_path / "j", (jp, jopt.init(jp)),
                             step=4)[0])
    tr = tloop.train(tsteps.build_mind_train_step(cfg), tp, topt.init(tp),
                     data(torch.from_numpy), ckpt_dir=tmp_path / "t",
                     max_steps=8, ckpt_every=4, **quiet)
    np.testing.assert_allclose(tr["losses"], jr["losses"][4:], **TOL)
    _assert_trees_close(tr["params"], jr["params"], "MIND params")


@pytest.mark.parametrize("neg_groups", [1, 2])
def test_mind_train_loss_grads_match_reference(neg_groups):
    jcfg = dataclasses.replace(jget_arch("mind").smoke_config(),
                               neg_groups=neg_groups)
    cfg = dataclasses.replace(get_arch("mind").smoke_config(),
                              neg_groups=neg_groups)
    jp = jmind.init_params(jcfg, jax.random.PRNGKey(1))
    tp = tmind.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(6)
    # repeated items: the table gather's backward sums them
    hist = rng.integers(0, 40, (8, cfg.hist_len)).astype(np.int32)
    mask = (rng.random((8, cfg.hist_len)) < 0.7).astype(np.float32)
    hist[mask == 0] = -1
    target = rng.integers(0, 40, 8).astype(np.int32)
    want, jg = jax.value_and_grad(jmind.train_loss)(
        jp, jnp.asarray(hist), jnp.asarray(mask), jnp.asarray(target), jcfg)
    got, g = tsteps.value_and_grad(
        lambda p, h, m, t: tmind.train_loss(p, h, m, t, cfg), tp,
        torch.from_numpy(hist), torch.from_numpy(mask),
        torch.from_numpy(target))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6,
                               rtol=1e-5)
    _assert_trees_close(g, jg, "MIND grads", atol=1e-6, rtol=1e-4)
    assert float(g["item_embed"][40:].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma-2b", "mind"])
def test_launcher_trains_and_resumes_on_cpu(arch, tmp_path, capsys):
    argv = ["--arch", arch, "--device", "cpu", "--steps", "4",
            "--ckpt-every", "2", "--batch", "2", "--seq-len", "16",
            "--ckpt-dir", str(tmp_path)]
    first = tlaunch.main(argv)
    assert len(first["losses"]) == 4
    assert all(np.isfinite(first["losses"]))
    assert tckpt.latest_step(tmp_path) == 4
    argv[argv.index("--steps") + 1] = "6"
    second = tlaunch.main(argv)
    out = capsys.readouterr().out
    assert "[loop] resumed from step 4" in out and "[train] done" in out
    assert len(second["losses"]) == 2 and second["final_step"] == 6


def test_launcher_keeps_the_reference_flags(tmp_path, monkeypatch):
    """The reference's flags and defaults, but for ``--ckpt-dir``: a
    directory of the arch's own under the temporary directory."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    args = tlaunch.parse_args(["--arch", "gemma-2b"])
    assert args.smoke is True and args.device == "cuda"
    assert args.ckpt_dir == str(tmp_path / "repro_torch_ckpt_gemma-2b")
    assert tlaunch.parse_args(["--arch", "mind"]).ckpt_dir != args.ckpt_dir
    with pytest.raises(SystemExit, match="streaming_analytics"):
        tlaunch.main(["--arch", "meerkat-graph", "--device", "cpu"])
