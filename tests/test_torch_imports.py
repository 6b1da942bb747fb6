"""The port runs without JAX: every module of ``repro_torch``, and
``chip_smoke.py``, imports in a process where ``import jax``, ``import
repro``, ``import msgpack`` and ``import ml_dtypes`` fail (the card's
machine has none of them).  The walk over the package must reach the
modules of the health engine, the kernel instrumentation, the sharded
plane, the MoE configs and MIND, and in the same process the sharded
plane's multi-process rendering runs on a one-rank gloo mesh (placement
with a WAL and audits attached, an epoch, a query, the fixpoints, the
triangle count, a checkpoint), a MoE smoke model's forward and MIND's
scores over histories from the graph, with ``torch.distributed`` and
nothing of JAX; and the training modules (``train/*``, ``launch/train.py``,
the chunked attention) train a smoke LM two steps through the loop, with a
checkpoint, and take a MIND train step; and the GNN family
(``models/gnn/*``, its configs, the sampler, kernel 4's op surface) takes
one smoke train step per batch style, geometric (NequIP) and feature
(PNA), with a batch from the sampler over a live graph's CSR snapshot;
and the four ``examples/torch_*.py`` import there, and the quickstart
runs on the CPU."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.modules["msgpack"] = None
sys.modules["ml_dtypes"] = None
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
import contextlib, importlib.util, io, pathlib
examples = {}
for ex in ("torch_quickstart", "torch_streaming_analytics",
           "torch_gnn_molecules", "torch_train_lm"):
    spec = importlib.util.spec_from_file_location(
        ex, pathlib.Path(sys.argv[2]) / "examples" / f"{ex}.py")
    examples[ex] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(examples[ex])
with contextlib.redirect_stdout(io.StringIO()):
    assert examples["torch_quickstart"].main(device="cpu")["deleted"] > 0

import os, tempfile
import numpy as np
import torch
from repro_torch import resilience as rz
from repro_torch.configs import get_arch
from repro_torch.distributed import ranks, sharded_graph as tsg
from repro_torch.models import transformer as tfm
from repro_torch.models.recsys import mind
from repro_torch.stream import ShardedGraphStore
tmp = tempfile.mkdtemp()
mesh = ranks.init_shard_mesh(0, 1, init_file=os.path.join(tmp, "rdzv"),
                             backend="gloo", device="cpu")
rng = np.random.default_rng(0)
src, dst = rng.integers(0, 40, (2, 200)).astype(np.uint32)
store = ShardedGraphStore.from_edges(40, 1, src, dst, device="cpu")
store.attach_wal(rz.WriteAheadLog(os.path.join(tmp, "wal")))
store.attach_audits(rz.AuditPolicy(every=1)).place_on_mesh(mesh)
assert store._mode() == "shard_map"
store.apply(dst[:20], src[:20], None, src[20:30], dst[20:30])
assert store.audit_events[-1]["ok"] and store.wal.appended == 1
store.query(src[:5], dst[:5])
tsg.wcc_sharded(store.symmetric)
tsg.pagerank_sharded(store.transpose, store.out_degree)
tsg.triangles_sharded(store.symmetric)
store.save(os.path.join(tmp, "ckpt"))
mcfg = get_arch("mind").smoke_config()
hist, mask = mind.history_from_slab(tsg.shard_slice(store.forward, 0),
                                    [0, 1, 2], hist_len=mcfg.hist_len)
scores = mind.serve_scores(mind.init_params(mcfg, torch.Generator()),
                           hist, mask, torch.arange(10), mcfg)
assert scores.shape == (3, 10)
ranks.close_shard_mesh()
cfg = get_arch("qwen3-moe-30b-a3b").smoke_config()
lm = tfm.TransformerLM(cfg, tfm.init_params(cfg, torch.Generator()))
assert lm(torch.zeros((1, 8), dtype=torch.long)).shape == (1, 8, 128)
from repro_torch.launch import steps
from repro_torch.train import loop, optimizer
gcfg = get_arch("gemma2-9b").smoke_config()
gp = tfm.init_params(gcfg, torch.Generator())
toks = torch.randint(0, 128, (2, 9), generator=torch.Generator())
batches = iter([(toks[:, :-1], toks[:, 1:])] * 2)
out = loop.train(steps.build_lm_train_step(gcfg, attn_impl="chunked"), gp,
                 optimizer.init(gp), batches,
                 ckpt_dir=os.path.join(tmp, "train"), max_steps=2,
                 log=lambda *a: None)
assert len(out["losses"]) == 2
mp = mind.init_params(mcfg, torch.Generator())
steps.build_mind_train_step(mcfg)(mp, optimizer.init(mp), hist, mask,
                                  torch.arange(3))
from repro_torch.core import csr_snapshot, from_edges_host
from repro_torch.data import sampler
from repro_torch.kernels.slab_pagerank import slab_contrib_sums
from repro_torch.models.gnn import common as gnn
for arch in ("nequip", "pna"):
    module, style = steps._GNN[arch]
    gcfg = get_arch(arch).smoke_config()
    gen = torch.Generator().manual_seed(0)
    gpar = module.init_params(gcfg, gen)
    if style == "geometric":
        b = gnn.random_geometric_batch(gen, 24, 80, n_graphs=2,
                                       n_species=gcfg.n_species)
        t = torch.zeros(2)
    else:
        live = from_edges_host(40, src, dst, device="cpu")
        csr = csr_snapshot(live, max_edges=4096)
        n = int(csr.n_edges)
        nodes, snd, rcv, em = sampler.sample_khop(
            csr.indptr.numpy().astype(np.int64), csr.indices.numpy()[:n],
            np.arange(4, dtype=np.int32), (3, 2))
        b = gnn.GraphBatch(
            positions=None, node_feat=torch.randn((40, gcfg.d_in)),
            species=None, senders=torch.from_numpy(snd),
            receivers=torch.from_numpy(rcv), edge_mask=torch.from_numpy(em),
            node_mask=torch.ones(40, dtype=torch.bool),
            graph_ids=torch.zeros(40, dtype=torch.int32), n_graphs=1)
        t = torch.zeros(40, dtype=torch.long)
    _, _, gl = steps.build_gnn_train_step(module, gcfg, style)(
        gpar, optimizer.init(gpar), b, t)
    assert bool(torch.isfinite(gl))
assert "torch.distributed" in sys.modules
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack",
                                    "ml_dtypes")
             and sys.modules[m] is not None)
missing = sorted({"repro_torch.obs.health", "repro_torch.obs.instrument",
                  "repro_torch.distributed.collectives",
                  "repro_torch.distributed.sharded_graph",
                  "repro_torch.distributed.ranks",
                  "repro_torch.stream.sharded_store",
                  "repro_torch.models.recsys.mind",
                  "repro_torch.configs.phi35_moe",
                  "repro_torch.configs.qwen3_moe",
                  "repro_torch.configs.mind",
                  "repro_torch.core.tree",
                  "repro_torch.train.optimizer", "repro_torch.train.loop",
                  "repro_torch.launch.train",
                  "repro_torch.kernels.flash_attention.chunked",
                  "repro_torch.kernels.slab_pagerank.ops",
                  "repro_torch.models.gnn.common",
                  "repro_torch.models.gnn.irreps",
                  "repro_torch.models.gnn.tensor_field",
                  "repro_torch.models.gnn.nequip",
                  "repro_torch.models.gnn.mace",
                  "repro_torch.models.gnn.pna",
                  "repro_torch.models.gnn.equiformer_v2",
                  "repro_torch.configs.mace",
                  "repro_torch.configs.nequip",
                  "repro_torch.configs.pna",
                  "repro_torch.configs.equiformer_v2",
                  "repro_torch.data.sampler"}
                 - set(names))
print(len(names), missing, bad)
"""


def test_port_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, str(ROOT / "src"), str(ROOT)],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, rest = out.stdout.split(maxsplit=1)
    assert int(n) > 20, out.stdout
    assert rest.strip() == "[] []", out.stdout
