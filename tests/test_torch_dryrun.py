"""Port parity: the dry run (``launch/dryrun.py``) on the CPU.

* **Flops**: for one smoke cell of each family (gemma-2b's train step with
  remat off, PNA's train step, MIND's ``serve_p99`` scoring), the port's
  traced flops (``FlopCounterMode``'s formulas over the step's operators
  on fake tensors) equal a count of the ``dot_general``s in the
  reference's ``jax.make_jaxpr`` of the same single-device step: 2 x the
  product of each product's dims (the lhs's dims and the rhs's free
  dims), scan bodies times their length, within 1e-6 relative.
* **Per device**: on a 2 x 2 mesh of a fake process group, a product whose
  operands are split over both axes counts one device's share (a quarter
  of the global flops, which ``FlopCounterMode`` entered over the DTensor
  operator reports).
* **Collectives**: the MoE dispatch buffers' redistribution from the
  big-LM layout (d_model over 'model') to the experts over 'model' counts
  as one all-to-all and no all-gather.
* **Peak**: the live storages of a known sequence of operators.
* **Graph cells**: ``run_cell`` of both ``meerkat-graph`` shapes runs the
  step for real on the stacked four-shard plane (on the CPU here, at a
  cut scale) and records ``"measured": true``.
* A ``run_cell`` on ``"single"`` of a small cell gives the record's fields.
No test leaves a process group behind.
"""
import math

import jax
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from _flops import jaxpr_dot_flops
from repro.launch import steps as jsteps
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed.sharding import P
from repro_torch.launch import dryrun
from repro_torch.launch import steps as tsteps


SMOKE_CELLS = [
    ("gemma-2b", "train_4k", {"global_batch": 2, "seq_len": 16},
     {"remat": False}),
    ("pna", "full_graph_sm", {"n_nodes": 60, "n_edges": 240, "d_feat": 24},
     None),
    ("mind", "serve_p99", {"batch": 8, "n_candidates": 64}, None),
]


@pytest.mark.parametrize("arch,shape,ov,cfg_ov", SMOKE_CELLS,
                         ids=[c[0] for c in SMOKE_CELLS])
def test_traced_flops_match_reference_jaxpr(arch, shape, ov, cfg_ov):
    jstep, jargs, _ = jsteps.make_cell(arch, shape, None, smoke=True,
                                       overrides=ov, cfg_overrides=cfg_ov)
    want = jaxpr_dot_flops(jax.make_jaxpr(jstep)(*jargs).jaxpr)
    assert want > 0
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args, _ = tsteps.make_cell(arch, shape, None, smoke=True,
                                         overrides=ov, cfg_overrides=cfg_ov)
        got = dryrun.trace_step(step, args)
    assert math.isclose(got["flops"], want, rel_tol=1e-6), (got["flops"],
                                                             want)


@pytest.fixture
def mesh22():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield init_device_mesh("cpu", (2, 2),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_flops_are_one_devices_share(mesh22):
    from torch.utils.flop_counter import FlopCounterMode

    M, K, N = 64, 32, 48
    with FakeTensorMode():
        a, b = torch.empty(M, K), torch.empty(K, N)
        specs = (P("data", None), P(None, "model"))
        res = dryrun.trace_step(lambda x, y: x @ y, (a, b), mesh=mesh22,
                                spec_trees=specs)
        with FlopCounterMode(display=False) as whole:
            da = tsh.distribute(a, mesh22, specs[0])
            db = tsh.distribute(b, mesh22, specs[1])
            da @ db
    assert whole.get_total_flops() == 2 * M * K * N
    assert res["flops"] == 2 * M * K * N // 4
    assert res["collectives"]["total_bytes"] == 0


def test_moe_dispatch_counts_as_all_to_all(mesh22):
    from repro_torch.models.transformer import _buffers

    G, E, C, D = 2, 4, 8, 16
    with FakeTensorMode():
        xe = torch.empty(G, E, C, D)
        # the grouped dispatch's buffers as the big-LM layout leaves them:
        # groups over 'data', d_model over 'model'
        res = dryrun.trace_step(lambda x: _buffers(x, True), (xe,),
                                mesh=mesh22,
                                spec_trees=(P("data", None, None, "model"),))
    coll = res["collectives"]
    assert coll["all-to-all"]["count"] == 1
    assert coll["all-to-all"]["bytes"] == G * E * C * D * 4 // 4
    assert coll["all-gather"]["count"] == 0


def test_peak_follows_the_live_storages():
    with FakeTensorMode():
        x = torch.empty(1024, dtype=torch.float32)      # 4 KiB argument

        def step(x):
            a = x * 2                     # +4 KiB
            b = torch.cat([a, a])         # +8 KiB: x, a and b, 16 KiB
            del a                         # -4 KiB
            c = b * 3                     # +8 KiB: x, b and c, 20 KiB
            del b
            return c.sum()                # +4 bytes
        res = dryrun.trace_step(step, (x,))
    assert res["argument_bytes"] == 4096
    assert res["peak"] == 4096 + 8192 + 8192
    assert res["output_bytes"] == 4


@pytest.mark.parametrize("shape", ["stream_10k", "analytics_pr"])
def test_graph_cells_run_for_real(shape):
    ov = {"n_vertices": 1 << 10, "capacity_slabs": 1 << 11, "batch": 256}
    rec = dryrun.run_cell("meerkat-graph", shape, "pod", overrides=ov,
                          device="cpu", verbose=False)
    assert rec["ok"] and rec["measured"] and rec["n_shards"] == 4
    assert rec["seconds"] > 0
    if shape == "stream_10k":
        assert 0 < rec["result"]["inserted"] <= 256
    else:
        assert 1 <= rec["result"]["iterations"] <= 20
        assert math.isclose(rec["result"]["pr_sum"], 1.0, rel_tol=1e-3)
    assert not dist.is_initialized()


def test_run_cell_single_record():
    rec = dryrun.run_cell("nequip", "molecule", "single", verbose=False)
    assert rec["ok"] and rec["n_devices"] == 1
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes_accessed"] > 0
    mem = rec["memory"]
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert set(rec["collectives"]) >= set(dryrun.COLLECTIVES) | {
        "total_bytes"}
    assert rec["collectives"]["total_bytes"] == 0
    skipped = dryrun.run_cell("gemma-2b", "long_500k", "pod",
                              verbose=False)
    assert skipped["ok"] and "skipped" in skipped
    assert not dist.is_initialized()


def test_graph_cells_default_to_the_card():
    """``run_cell``'s graph cells run on the card unless the caller names
    the CPU, and raise without one, as the serve and the trainer do; a CPU
    record's file name says so."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.run_cell("meerkat-graph", "stream_10k", "single",
                        verbose=False)
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "meerkat-graph", "--shape", "stream_10k",
                     "--mesh", "single", "--device", "tpu"])
    assert dryrun.record_name("meerkat-graph", "stream_10k", "pod",
                              device="cpu") == \
        "meerkat-graph__stream_10k__pod__cpu"
    assert dryrun.record_name("meerkat-graph", "stream_10k", "pod") == \
        "meerkat-graph__stream_10k__pod"
    assert dryrun.record_name("gemma-2b", "train_4k", "pod", "x",
                              device="cpu") == "gemma-2b__train_4k__pod__x"


def test_kernel_trace_needs_a_card_and_one_device():
    """``attn_impl="kernel"`` traces an LM step on CUDA fake tensors: on a
    mesh (the fake group's CPU meshes) it is refused, and so it is on a
    torch without a card."""
    with pytest.raises(ValueError, match="single"):
        dryrun.run_cell("gemma-2b", "train_4k", "pod", attn_impl="kernel",
                        verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.run_cell("gemma-2b", "train_4k", "single",
                        attn_impl="kernel", verbose=False)
    with pytest.raises(ValueError, match="attn_impl"):
        dryrun.run_cell("gemma-2b", "train_4k", "single",
                        attn_impl="pallas2", verbose=False)
    assert not dist.is_initialized()


ATTN_OP_CASES = [  # (B, Hq, Hkv, Sq, Skv, D, causal, window, kv_len)
    (2, 4, 2, 64, 64, 32, True, 0, 64),
    (1, 8, 1, 48, 80, 16, True, 16, 70),
    (1, 2, 2, 33, 33, 64, False, 0, 20),
]


@pytest.mark.parametrize("case", ATTN_OP_CASES,
                         ids=[f"op{i}" for i in range(len(ATTN_OP_CASES))])
def test_kernel_operators_trace_with_their_formula(case):
    """The main path's attention on CUDA tensors is the registered
    operator ``repro_torch::flash_attention_fwd``, whose autograd formula
    is ``repro_torch::flash_attention_bwd``: under ``FakeTensorMode`` (CPU
    fakes here; the card's trace makes them on the CUDA device) a forward
    and a backward through them hold each operator once, with the kernels'
    output shapes and the flop formula over the pairs ``ref.visibility``
    lets attention see; the operators launch the kernels, whose wrappers
    refuse real CPU tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.flash_attention import attention_flops
    from repro_torch.kernels.flash_attention.ops import visible_pairs
    from repro_torch.kernels.flash_attention.ref import visibility

    B, Hq, Hkv, Sq, Skv, D, causal, window, kv_len = case
    assert visible_pairs(Sq, Skv, causal=causal, window=window,
                         kv_len=kv_len) == int(visibility(
                             Sq, Skv, causal=causal, window=window,
                             kv_len=kv_len).sum())
    with FakeTensorMode():
        q = torch.empty(B, Hq, Sq, D, requires_grad=True)
        k = torch.empty(B, Hkv, Skv, D, requires_grad=True)
        v = torch.empty(B, Hkv, Skv, D, requires_grad=True)
        trace = dryrun.Trace()
        with trace:
            o, lse = torch.ops.repro_torch.flash_attention_fwd(
                q, k, v, causal, window, 0.0, D ** -0.5, kv_len)
            o.sum().backward()
        assert o.shape == q.shape and lse.shape == (B, Hq, Sq)
        assert lse.dtype == torch.float32
        assert (q.grad.shape, k.grad.shape, v.grad.shape) == \
            (q.shape, k.shape, v.shape)
    res = trace.result()
    assert res["custom_ops"] == {"repro_torch.flash_attention_fwd.default": 1,
                                 "repro_torch.flash_attention_bwd.default": 1}
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    want = {"repro_torch.flash_attention_fwd":
            attention_flops(q.shape, k.shape, **kw),
            "repro_torch.flash_attention_bwd":
            attention_flops(q.shape, k.shape, backward=True, **kw)}
    assert {n: res["flops_by_op"][n] for n in want} == want
    with FlopCounterMode(display=False) as fc, FakeTensorMode():
        torch.ops.repro_torch.flash_attention_fwd(
            torch.empty(B, Hq, Sq, D), torch.empty(B, Hkv, Skv, D),
            torch.empty(B, Hkv, Skv, D), causal, window, 0.0, 1.0, kv_len)
    assert fc.get_total_flops() == want["repro_torch.flash_attention_fwd"]
    real = torch.zeros(B, Hq, Sq, D)
    with pytest.raises(ValueError, match="CUDA"):
        torch.ops.repro_torch.flash_attention_fwd(
            real, torch.zeros(B, Hkv, Skv, D), torch.zeros(B, Hkv, Skv, D),
            causal, window, 0.0, 1.0, kv_len)
