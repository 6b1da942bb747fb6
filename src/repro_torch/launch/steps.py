"""Step builders for the LM, GNN and recsys families, from
``repro.launch.steps``.

``build_lm_train_step`` (forward, backward and AdamW, with microbatch
accumulation), ``build_gnn_train_step`` and ``build_mind_train_step``
return the step a trainer calls per batch, over the reference's parameter
pytree as a dict of tensors; ``build_lm_prefill_step`` and
``build_lm_decode_step`` return the step a server calls per request, over
a ``TransformerLM``.  ``ADAMW``, ``MICROBATCH`` and ``_GNN`` are the
reference's.  The input and sharding specs and the ``*_cell`` builders
belong to the dry run (ROADMAP §1).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..core import tree
from ..models import transformer as tfm
from ..models.gnn import equiformer_v2 as eq2
from ..models.gnn import mace as mace_m
from ..models.gnn import nequip as nequip_m
from ..models.gnn import pna as pna_m
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
    mb = tokens.shape[0] // n_microbatches
    return _microbatch_grads(loss, params,
                             [(tokens[i * mb:(i + 1) * mb],
                               labels[i * mb:(i + 1) * mb])
                              for i in range(n_microbatches)])


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


def build_lm_prefill_step(cfg: LMConfig) -> Callable:
    """``prefill_step(model, tokens) -> (last logits (B, V), cache)``."""
    def prefill_step(model: TransformerLM, tokens):
        _check(model, cfg)
        return model.prefill(tokens)
    return prefill_step


def build_lm_decode_step(cfg: LMConfig) -> Callable:
    """``serve_step(model, cache, token, pos) -> (logits (B, V), cache)``;
    the cache is updated in place."""
    def serve_step(model: TransformerLM, cache, token, pos):
        _check(model, cfg)
        return model.decode_step(cache, token, pos)
    return serve_step
