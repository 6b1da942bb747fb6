"""Step builders, input specs and sharding specs for every (arch x shape)
cell, from ``repro.launch.steps``.

``build_lm_train_step`` (forward, backward and AdamW, with microbatch
accumulation), ``build_gnn_train_step`` and ``build_mind_train_step``
return the step a trainer calls per batch, over the reference's parameter
pytree as a dict of tensors; ``build_lm_prefill_step`` and
``build_lm_decode_step`` return the step a server calls per request, over
a ``TransformerLM``.  ``ADAMW``, ``MICROBATCH`` and ``_GNN`` are the
reference's.

The cell builders (``lm_cell``, ``gnn_cell``, ``mind_cell``,
``graph_cell``, ``make_cell``) give the dry run ``(step, args, specs)``:
the step as the reference's cell defines it, its arguments as fake tensors
(``sds``; the parameters from each model's own ``init_params`` under
``FakeTensorMode``, never materialised) in place of ``ShapeDtypeStruct``,
and the spec trees (``distributed.sharding.P``) of the reference's
``PartitionSpec`` trees.  Departures: the LM and MIND train steps update
in place (``donate``), as the card runs them; the prefill and decode steps
take the parameter dict and wrap it in a ``TransformerLM``; the decode
step writes its cache at a host position, so a fake ``pos`` traces at
position ``seq_len - 1`` (the attention reads every slot under a mask, so
the costs do not depend on it).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from ..configs import get_arch
from ..configs.common import sampled_subgraph_size
from ..core import tree
from ..distributed.sharding import P, dp_axes
from ..models import transformer as tfm
from ..models.gnn import equiformer_v2 as eq2
from ..models.gnn import mace as mace_m
from ..models.gnn import nequip as nequip_m
from ..models.gnn import pna as pna_m
from ..models.gnn.common import GraphBatch
from ..models.recsys import mind as mind_m
from ..models.transformer import LMConfig, TransformerLM
from ..train import optimizer as opt

ADAMW = opt.AdamWConfig()

#: per-(arch, shape) microbatch counts (memory lever)
MICROBATCH = {
    ("qwen1.5-32b", "train_4k"): 4,
    ("gemma2-9b", "train_4k"): 4,
    ("gemma-2b", "train_4k"): 2,
    # MoE: the sort-based dispatch buffers scale with tokens a microbatch
    ("phi3.5-moe-42b-a6.6b", "train_4k"): 8,
    ("qwen3-moe-30b-a3b", "train_4k"): 8,
}


def _trainable(params):
    """``params`` as leaves that record gradients (detached views: no
    copy)."""
    return tree.tree_map(lambda p: p.detach().requires_grad_(), params)


def value_and_grad(loss: Callable, params, *args) -> Tuple[torch.Tensor,
                                                          object]:
    """``(loss(params, *args), its gradient)`` for a parameter tree, as
    ``jax.value_and_grad``: the gradient has ``params``' structure and
    dtypes, and a leaf the loss does not read gets zeros."""
    tp = _trainable(params)
    leaves = tree.tree_leaves(tp)
    value = loss(tp, *args)
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return value.detach(), tree.tree_unflatten(params, grads)


def _microbatch_grads(loss: Callable, params, batches):
    """Gradients summed in float32 over ``batches`` and divided once, and
    the mean loss, as the reference's scan over microbatches.  A float32
    tree accumulates in its leaves' ``.grad`` (in place, one leaf's
    gradient at a time); any other is summed into float32 buffers."""
    n = len(batches)
    tp = _trainable(params)
    leaves = tree.tree_leaves(tp)
    in_grad = all(p.dtype == torch.float32 for p in leaves)
    gsum, lsum = None, None
    for args in batches:
        value = loss(tp, *args)
        if in_grad:
            value.backward()
        else:
            g = torch.autograd.grad(value, leaves)
            gsum = [x.float() for x in g] if gsum is None else \
                [a.add_(b) for a, b in zip(gsum, g)]
            del g
        value = value.detach()
        lsum = value if lsum is None else lsum + value
    if in_grad:
        gsum = [p.grad for p in leaves]
    for g in gsum:
        g.div_(n)
    return lsum / n, tree.tree_unflatten(params, gsum)


def lm_value_and_grad(cfg: LMConfig, params, tokens, labels, *,
                      n_microbatches: int = 1, attn_impl: str = "ref"):
    """``(loss, grads)`` of ``loss_fn`` as the train step takes them: over
    the whole batch, or summed in float32 over ``n_microbatches`` equal
    slices of it and divided once (the mean loss beside)."""
    def loss(p, t, l):
        return tfm.loss_fn(p, t, l, cfg, attn_impl=attn_impl)

    if n_microbatches == 1:
        return value_and_grad(loss, params, tokens, labels)
    return _microbatch_grads(loss, params,
                             [(_microbatch(tokens, i, n_microbatches),
                               _microbatch(labels, i, n_microbatches))
                              for i in range(n_microbatches)])


def _microbatch(t: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Rows ``i * mb .. (i + 1) * mb - 1`` of ``t`` (mb = B / n), as the
    reference's scan takes them.  A DTensor whose batch is split over the
    mesh (the dry run on a mesh) takes rows i, i + n, ... instead: DTensor
    cannot cut a split dim into n contiguous blocks without gathering it,
    and the costs are the same (the dry run computes no values)."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        return t.reshape(-1, n, *t.shape[1:])[:, i]
    mb = t.shape[0] // n
    return t[i * mb:(i + 1) * mb]


def build_lm_train_step(cfg: LMConfig, *, n_microbatches: int = 1,
                        attn_impl: str = "ref",
                        donate: bool = False) -> Callable:
    """``train_step(params, opt_state, tokens, labels) -> (params,
    opt_state, loss)``: ``lm_value_and_grad``, then one AdamW step
    (``ADAMW``).  ``donate`` updates ``params`` and the moments in place
    (the caller must use the returned trees), which a card needs at full
    width."""
    def train_step(params, opt_state, tokens, labels):
        value, grads = lm_value_and_grad(cfg, params, tokens, labels,
                                         n_microbatches=n_microbatches,
                                         attn_impl=attn_impl)
        new_params, new_opt = opt.update(ADAMW, grads, opt_state, params,
                                         inplace=donate)
        return new_params, new_opt, value

    return train_step


def build_mind_train_step(cfg: mind_m.MINDConfig, *,
                          donate: bool = False) -> Callable:
    """``step(params, opt_state, hist, mask, target) -> (params, opt_state,
    loss)``: MIND's ``train_loss`` and its gradients, then one AdamW step,
    as the reference's recsys trainer (``repro/launch/train.py``)."""
    def loss(p, hist, mask, target):
        return mind_m.train_loss(p, hist, mask, target, cfg)

    def step(params, opt_state, hist, mask, target):
        value, grads = value_and_grad(loss, params, hist, mask, target)
        new_params, new_opt = opt.update(ADAMW, grads, opt_state, params,
                                         inplace=donate)
        return new_params, new_opt, value

    return step


#: GNN arch -> (model module, batch style): "geometric" batches carry
#: positions and species (an energy regression), "feature" batches node
#: features (node classification)
_GNN = {
    "mace": (mace_m, "geometric"),
    "nequip": (nequip_m, "geometric"),
    "pna": (pna_m, "feature"),
    "equiformer-v2": (eq2, "geometric"),
}


def build_gnn_train_step(module, cfg, style: str) -> Callable:
    """``train_step(params, opt_state, batch, targets) -> (params,
    opt_state, loss)``: the model's loss (``energy_loss`` on per-graph
    energies, or ``node_xent_loss`` on node labels) and its gradients, then
    one AdamW step (``ADAMW``).  The batch's positions take no gradient."""
    if style == "geometric":
        def loss_fn(params, batch, targets):
            return module.energy_loss(params, batch, targets, cfg)
    else:
        def loss_fn(params, batch, targets):
            return module.node_xent_loss(params, batch, targets, cfg)

    def train_step(params, opt_state, batch, targets):
        loss, grads = value_and_grad(loss_fn, params, batch, targets)
        new_params, new_opt = opt.update(ADAMW, grads, opt_state, params)
        return new_params, new_opt, loss

    return train_step


def _check(model: TransformerLM, cfg: LMConfig) -> None:
    if model.cfg != cfg:
        raise ValueError(f"the step was built for {cfg.name}, the model is "
                         f"{model.cfg.name}")


def build_lm_prefill_step(cfg: LMConfig, attn_impl: str = "ref"
                          ) -> Callable:
    """``prefill_step(model, tokens) -> (last logits (B, V), cache)``."""
    def prefill_step(model: TransformerLM, tokens):
        _check(model, cfg)
        return model.prefill(tokens, attn_impl=attn_impl)
    return prefill_step


def build_lm_decode_step(cfg: LMConfig) -> Callable:
    """``serve_step(model, cache, token, pos) -> (logits (B, V), cache)``;
    the cache is updated in place."""
    def serve_step(model: TransformerLM, cache, token, pos):
        _check(model, cfg)
        return model.decode_step(cache, token, pos)
    return serve_step


# ===========================================================================
# cell builders: (step, args, spec trees) for the dry run
# ===========================================================================

def _fake_mode():
    """The running ``FakeTensorMode``, or a new one (it takes the host
    arrays the slab-graph builders make as constants)."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    return detect_fake_mode() or FakeTensorMode(allow_non_fake_inputs=True)


@contextlib.contextmanager
def _faking():
    """Inside: factories make fake tensors (the running mode's, or a new
    one's)."""
    from torch._guards import detect_fake_mode

    if detect_fake_mode() is not None:
        yield
        return
    with _fake_mode():
        yield


def sds(shape, dtype, device="cpu") -> torch.Tensor:
    """A stand-in for ``jax.ShapeDtypeStruct``: an uninitialised tensor of
    ``shape`` and ``dtype`` (a fake one inside a cell builder)."""
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device=device)


def _generator() -> torch.Generator:
    return torch.Generator().manual_seed(0)


# ------------------------------------------------------------------- LM ----

def lm_param_specs(cfg: LMConfig, mesh=None) -> Dict:
    """Spec tree matching ``tfm.init_params``: tensor parallel over
    'model' (heads, d_ff, experts, vocab) x FSDP over the batch-like axes
    (the d_model dim), parameters and optimizer state fully sharded."""
    dp = dp_axes(mesh) if mesh is not None else ("data",)
    layers = {
        "wq": P(None, dp, "model"),
        "wk": P(None, dp, "model"),
        "wv": P(None, dp, "model"),
        "wo": P(None, "model", dp),
        "ln_attn": P(None, None),
        "ln_mlp": P(None, None),
    }
    if cfg.qkv_bias:
        layers |= {"bq": P(None, "model"), "bk": P(None, "model"),
                   "bv": P(None, "model")}
    if cfg.qk_norm:
        layers |= {"q_norm": P(None, None), "k_norm": P(None, None)}
    if cfg.is_moe:
        layers |= {
            "router": P(None, None, None),
            "w_gate": P(None, "model", dp, None),
            "w_up": P(None, "model", dp, None),
            "w_down": P(None, "model", None, dp),
        }
    else:
        layers |= {
            "w_gate": P(None, dp, "model"),
            "w_up": P(None, dp, "model"),
            "w_down": P(None, "model", dp),
        }
    specs = {"embed": P("model", dp), "final_norm": P(None),
             "layers": layers}
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(dp, "model")
    return specs


def lm_opt_specs(param_specs) -> opt.AdamWState:
    return opt.AdamWState(m=param_specs,
                          v=_spec_map(lambda s: s, param_specs), count=P())


def _spec_map(fn, specs):
    """``fn`` over a spec tree's leaves (a ``P`` is a leaf, not a
    tuple)."""
    if isinstance(specs, P) or specs is None:
        return fn(specs)
    if isinstance(specs, dict):
        return {k: _spec_map(fn, v) for k, v in specs.items()}
    return type(specs)(*(_spec_map(fn, v) for v in specs)) \
        if hasattr(specs, "_fields") else type(specs)(
            _spec_map(fn, v) for v in specs)


def lm_cell(cfg: LMConfig, shape: Dict, mesh=None, *,
            n_microbatches: int = 1, attn_impl: str = "ref",
            param_dtype: torch.dtype = torch.float32):
    """``(step, args, specs)`` of an LM cell: train (the step updates in
    place), prefill or decode.  ``param_dtype`` is the parameters' dtype
    (the reference's float32 by default)."""
    kind = shape["kind"]
    S, B = shape["seq_len"], shape["global_batch"]
    dp = dp_axes(mesh) if mesh is not None else ("data",)
    pspecs = lm_param_specs(cfg, mesh)
    with _faking():
        params = tfm.init_params(cfg, _generator(), dtype=param_dtype)
        if kind == "train":
            step = build_lm_train_step(cfg, n_microbatches=n_microbatches,
                                       attn_impl=attn_impl, donate=True)
            args = (params, opt.init(params), sds((B, S), torch.int32),
                    sds((B, S), torch.int32))
            return step, args, (pspecs, lm_opt_specs(pspecs), P(dp, None),
                                P(dp, None))

        if kind == "prefill":
            def prefill_step(params, tokens):
                return TransformerLM(cfg, params).prefill(
                    tokens, attn_impl=attn_impl)
            return prefill_step, (params, sds((B, S), torch.int32)), \
                (pspecs, P(dp, None))

        # decode
        cache = tfm.init_cache(cfg, B, S, device="cpu")
    if B == 1:
        cache_spec = P(None, None, None, dp + ("model",), None)
    else:
        cache_spec = P(None, dp, None, "model", None)
    cspecs = {k: cache_spec for k in cache}

    def serve_step(params, cache, token, pos):
        from torch._subclasses.fake_tensor import FakeTensor
        local = getattr(pos, "_local_tensor", pos)    # a DTensor's own
        p = S - 1 if isinstance(local, FakeTensor) else int(pos)
        return TransformerLM(cfg, params).decode_step(cache, token, p)

    with _faking():
        args = (params, cache, sds((B,), torch.int32), sds((), torch.int32))
    tok_spec = P(dp) if B > 1 else P(None)
    return serve_step, args, (pspecs, cspecs, tok_spec, P())


# ------------------------------------------------------------------ GNN ----

def gnn_batch_specs(n_nodes: int, n_edges: int, *, style: str,
                    d_feat: int = 0, n_graphs: int = 1) -> GraphBatch:
    geo = style == "geometric"
    with _faking():
        return GraphBatch(
            positions=sds((n_nodes, 3), torch.float32) if geo else None,
            node_feat=(sds((n_nodes, d_feat), torch.float32)
                       if style == "feature" else None),
            species=sds((n_nodes,), torch.int32) if geo else None,
            senders=sds((n_edges,), torch.int32),
            receivers=sds((n_edges,), torch.int32),
            edge_mask=sds((n_edges,), torch.bool),
            node_mask=sds((n_nodes,), torch.bool),
            graph_ids=sds((n_nodes,), torch.int32),
            n_graphs=n_graphs)


def gnn_batch_shardings(mesh, batch: GraphBatch) -> GraphBatch:
    dp = dp_axes(mesh) if mesh is not None else ("data",)
    node = P(dp + ("model",))
    edge = P(dp + ("model",))
    return GraphBatch(
        positions=None if batch.positions is None else P(dp + ("model",),
                                                         None),
        node_feat=None if batch.node_feat is None else P(dp + ("model",),
                                                         None),
        species=None if batch.species is None else node,
        senders=edge, receivers=edge, edge_mask=edge,
        node_mask=node, graph_ids=node, n_graphs=batch.n_graphs)


def _pad_to(n: int, mult: int = 512) -> int:
    """Pad-to-shard: the models carry node and edge masks, so padding is
    semantically free."""
    return -(-n // mult) * mult


def gnn_size(shape: Dict) -> Tuple[int, int, int]:
    """(nodes, edges, graphs) a step of ``shape``, as ``gnn_cell`` reads
    them (before padding)."""
    kind = shape["kind"]
    if kind == "train":
        return shape["n_nodes"], shape["n_edges"], 1
    if kind == "train_sampled":
        return (*sampled_subgraph_size(shape), 1)
    return (shape["n_nodes"] * shape["batch"],
            shape["n_edges"] * shape["batch"], shape["batch"])


def gnn_cell(arch_id: str, cfg, shape: Dict, mesh=None):
    module, style = _GNN[arch_id]
    n_nodes, n_edges, n_graphs = gnn_size(shape)
    if mesh is not None:
        n_nodes = _pad_to(n_nodes)
        n_edges = _pad_to(n_edges)
    d_feat = shape.get("d_feat") or getattr(cfg, "d_in", 0)
    batch = gnn_batch_specs(n_nodes, n_edges, style=style, d_feat=d_feat,
                            n_graphs=n_graphs)
    with _faking():
        params = module.init_params(cfg, _generator())
        ostate = opt.init(params)
        if style == "geometric":
            targets = sds((n_graphs,), torch.float32)
        else:
            targets = sds((n_nodes,), torch.int32)
    step = build_gnn_train_step(module, cfg, style)
    if style == "geometric":
        t_spec = P(dp_axes(mesh)) if (mesh and n_graphs > 1) else P(None)
    else:
        t_spec = P(dp_axes(mesh) + ("model",)) if mesh else P(None)
    pspec = tree.tree_map(lambda _: P(), params)    # replicated params
    ospec = tree.tree_map(lambda _: P(), ostate)
    args = (params, ostate, batch, targets)
    return step, args, (pspec, ospec, gnn_batch_shardings(mesh, batch),
                        t_spec)


# --------------------------------------------------------------- recsys ----

def mind_cell(cfg: mind_m.MINDConfig, shape: Dict, mesh=None):
    kind = shape["kind"]
    B = shape["batch"]
    L = cfg.hist_len
    dp = dp_axes(mesh) if mesh is not None else ("data",)
    pspec = {"item_embed": P(dp + ("model",), None), "S": P()}
    b_spec = P(dp) if B > 1 else P(None)
    with _faking():
        params = mind_m.init_params(cfg, _generator())
        hist, mask = sds((B, L), torch.int32), sds((B, L), torch.float32)
        if kind == "train":
            step = build_mind_train_step(cfg, donate=True)
            ospec = opt.AdamWState(m=pspec, v=dict(pspec), count=P())
            args = (params, opt.init(params), hist, mask,
                    sds((B,), torch.int32))
            return step, args, (pspec, ospec, P(dp, None), P(dp, None),
                                b_spec)

        if kind == "serve":
            Nc = shape["n_candidates"]

            def step(params, hist, mask, candidates):
                return mind_m.serve_scores(params, hist, mask, candidates,
                                           cfg)
            args = (params, hist, mask, sds((Nc,), torch.int32))
            h_spec = P(dp, None) if B > 1 else P(None, None)
            return step, args, (pspec, h_spec, h_spec, P(None))

        # retrieval: 1 query against 10^6 candidate embeddings
        Nc = _pad_to(shape["n_candidates"]) if mesh is not None \
            else shape["n_candidates"]

        def step(params, hist, mask, cand_embed):
            return mind_m.retrieval_scores(params, hist, mask, cand_embed,
                                           cfg)
        args = (params, hist, mask, sds((Nc, cfg.embed_dim), torch.float32))
        return step, args, (pspec, P(None, None), P(None, None),
                            P(dp + ("model",), None))


# --------------------------------------------------------- meerkat-graph ----

def _mesh_size(mesh) -> int:
    return int(mesh.size()) if mesh is not None else 4


def _mesh_axes(mesh):
    if mesh is None:
        return ("data",)
    return tuple(mesh.mesh_dim_names)


def graph_cell(cfg: Dict, shape: Dict, mesh=None, *, device=None):
    """One shard a device: a batched update's routing and commit
    (``graph_update``), or distributed incremental PageRank with a warm
    start (``graph_pagerank``).  The pools are ``shard_empty``'s, stacked
    on ``device`` (fake tensors when ``device`` is None); the specs shard
    the stacked shard dim over every mesh axis.  The plane reads the host
    inside its steps (routing sizes, fixpoint tests), so the dry run runs
    these steps for real (``launch.dryrun``) rather than tracing them."""
    from ..distributed import sharded_graph as SGR

    n_shards = _mesh_size(mesh)
    V = shape["n_vertices"]
    cap_shard = max(64, shape["capacity_slabs"] // n_shards)
    ctx = _faking() if device is None else contextlib.nullcontext()
    with ctx:
        dev = "cpu" if device is None else device
        sg = SGR.shard_empty(V, n_shards, capacity_slabs_per_shard=cap_shard,
                             device=dev)
    axes = _mesh_axes(mesh)
    g_specs = tree.tree_map(
        lambda x: P(*((axes,) + (None,) * (x.dim() - 1))) if x.dim() >= 1
        else P(), sg.graphs)
    sg_specs = dataclasses.replace(sg, graphs=g_specs)

    def make(shape_, dtype):
        if device is None:
            with _faking():
                return sds(shape_, dtype)
        return torch.empty(shape_, dtype=dtype, device=device)

    if shape["kind"] == "graph_update":
        B = shape["batch"]

        def step(sg, src, dst):
            return SGR.insert_edges_sharded(sg, src, dst, cap=None)
        # the reference's ids are uint32; the port's are int32 bit patterns
        args = (sg, make((B,), torch.int32), make((B,), torch.int32))
        return step, args, (sg_specs, P(None), P(None))

    def step(sg, out_degree, prev_pr):
        return SGR.pagerank_sharded(sg, out_degree, init_pr=prev_pr,
                                    max_iter=20)
    args = (sg, make((V,), torch.int32), make((V,), torch.float32))
    return step, args, (sg_specs, P(None), P(None))


# ------------------------------------------------------------ entry point ----

def make_cell(arch_id: str, shape_name: str, mesh=None, *,
              smoke: bool = False, attn_impl: str = "ref",
              overrides: Optional[Dict] = None,
              cfg_overrides: Optional[Dict] = None,
              lm_layers: Optional[int] = None,
              lm_micro: Optional[int] = None,
              param_dtype: torch.dtype = torch.float32):
    """``(step, args, spec trees)`` for one grid cell, the arguments fake
    tensors.  ``overrides`` update the shape, ``cfg_overrides`` the config
    (a dataclass's fields); ``lm_layers`` and ``lm_micro`` set an LM's
    layer count and microbatches; ``param_dtype`` an LM's parameter
    dtype."""
    m = get_arch(arch_id)
    shape = dict(m.SHAPES[shape_name])
    if overrides:
        shape.update(overrides)
    cfg = m.smoke_config() if smoke else m.full_config()
    if m.FAMILY == "gnn" and arch_id == "pna" and not smoke:
        cfg = m.full_config(d_in=shape.get("d_feat", 100) or 100)
    if cfg_overrides and dataclasses.is_dataclass(cfg):
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    if m.FAMILY == "lm":
        if lm_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=lm_layers)
        nmb = MICROBATCH.get((arch_id, shape_name), 1) if not smoke else 1
        if lm_micro is not None:
            nmb = lm_micro
        return lm_cell(cfg, shape, mesh, n_microbatches=nmb,
                       attn_impl=attn_impl, param_dtype=param_dtype)
    if m.FAMILY == "gnn":
        return gnn_cell(arch_id, cfg, shape, mesh)
    if m.FAMILY == "recsys":
        return mind_cell(cfg, shape, mesh)
    if m.FAMILY == "graph":
        return graph_cell(cfg, shape, mesh)
    raise ValueError(f"family {m.FAMILY} has no generic cell builder")
