"""Decoder-only LM, serving and training, from ``repro.models.transformer``.

One parameterised stack for the reference's five LM configs (phi3.5-moe:
GQA, 16 experts top-2; qwen3-moe: GQA, QK norm, 128 experts top-8;
gemma-2b: MQA, GeGLU, embedding scaling; gemma2-9b: GQA, local(4096) and
global layers alternating, attention and final softcaps; qwen1.5-32b: MHA,
QKV bias).  ``TransformerLM`` holds the layer-stacked parameters under the
reference's pytree names (``embed``, ``final_norm``, ``lm_head``,
``layers.<name>`` with a leading layer dimension) and serves ``forward``,
``prefill`` and ``decode_step`` with the reference's outputs; its parameters
take no gradient.  Training is functional, as the reference's: ``forward``
and ``loss_fn`` over a parameter dict whose leaves may require gradients,
each layer (an alternating stack's local/global pair, as the reference's
pair scan) under ``torch.utils.checkpoint`` when ``cfg.remat`` is set.

Departures from the reference:

* Attention goes through ``kernels.flash_attention``: the hand-written
  kernel (forward, and its backward under autograd) for tensors on the
  card, the plain ``attention_ref`` for CPU tensors.  The reference
  defaults to its plain version and reaches its Pallas kernel only when
  asked (``attn_impl="pallas"``); the port's ``attn_impl`` "ref" and
  "pallas" are both that op, and "chunked" is the reference's plain
  schedule (``kernels.flash_attention.chunked``) on any device.  Serving
  always takes the op.
* A Python loop over the layers replaces ``lax.scan``; a layer's attention
  is local or global by its parity (``LMConfig.layer_window``), and only
  that attention is computed.
* ``decode_step`` writes the new key and value into the cache in place and
  returns the same dict.
* The sharding constraints (``distributed.sharding.constrain``) sit at
  the reference's sites: identities outside a rules context or on plain
  tensors, so no path on one device changes; inside one, on the dry run's
  DTensors, redistributions.
* ``moe_ffn`` sums a token's kept expert contributions in a fixed order
  (its experts ascending, one rounding an addition in the buffers' dtype,
  as the reference's ``segment_sum`` adds them), not with atomics, and
  breaks top-k ties toward the lower expert, as ``jax.lax.top_k`` does.
* ``init_params`` draws the expert-stacked leaves one layer at a time (a
  float32 temporary of one layer, not of the whole stack).
* The one-layer alternating stack (the reference's dry-run calibration
  variant) runs as the reference runs it: ``forward`` and ``prefill`` take
  the single layer's weights as a (local, global) pair, keeping the local
  layer's cache; ``decode_step`` runs the layer as local, on its ring.
* Remat's unit is a layer (a pair for alternating stacks) under
  ``checkpoint(use_reentrant=False)``; ``remat_policy="dots"`` saves the
  outputs of the weight products (``aten.mm``, as the reference's
  ``dots_with_no_batch_dims_saveable`` saves its batch-free dots) through
  ``create_selective_checkpoint_contexts`` and recomputes the rest.
* ``cast_params_once`` casts the whole parameter tree to ``cfg.dtype``
  once, before the layers (a step's FSDP gathers then move bf16).
  ``scan_unroll`` is not a field: the reference unrolls its layer scan only
  because XLA's cost analysis counts a loop body once, and the port's
  layers are a Python loop that a flop counter counts in full.
* The final softcap runs in place on the logits when nothing records a
  gradient (serving), out of place otherwise.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from ..distributed.sharding import (constrain, fit_heads, fsdp_gather,
                                    local_heads, stacked_like)
from ..kernels.flash_attention import attention_chunked, flash_attention

#: the layer-stacked parameter names a config may have
LAYER_PARAMS = ("wq", "wk", "wv", "wo", "ln_attn", "ln_mlp", "bq", "bk",
                "bv", "q_norm", "k_norm", "router", "w_gate", "w_up",
                "w_down")


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # MoE (n_experts == 0 -> dense FFN)
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # attention flavour
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int = 0            # >0 enables local attention layers
    local_global_alternate: bool = False  # even layers local, odd global
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    # misc
    activation: str = "swiglu"         # or "geglu"
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    embed_scale: bool = False          # gemma: x *= sqrt(d_model)
    tie_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True     # checkpoint each layer (pair) in training
    dispatch_groups: int = 1  # shard-local MoE dispatch over G token groups
    cast_params_once: bool = False  # the whole tree to dtype, once a step
    remat_policy: str = "full"      # or "dots": save the weight products

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def has_local(self) -> bool:
        """Alternating local (ring-buffer cache) and global layers."""
        return bool(self.local_global_alternate and self.sliding_window)

    def layer_window(self, layer: int) -> int:
        """Sliding window of ``layer``'s attention (0: global)."""
        if self.has_local and layer % 2:
            return 0
        return self.sliding_window

    def n_params(self) -> int:
        """Total parameter count."""
        D, hd = self.d_model, self.head_dim
        attn = D * (self.n_heads + 2 * self.n_kv_heads) * hd \
            + self.n_heads * hd * D
        if self.is_moe:
            ffn = D * self.n_experts + self.n_experts * 3 * D * self.d_ff
        else:
            ffn = 3 * D * self.d_ff
        per_layer = attn + ffn + 2 * D
        emb = self.vocab_size * D * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + D

    def n_active_params(self) -> int:
        """Active parameters a token (MoE: its top_k experts only)."""
        if not self.is_moe:
            return self.n_params()
        D, hd = self.d_model, self.head_dim
        attn = D * (self.n_heads + 2 * self.n_kv_heads) * hd \
            + self.n_heads * hd * D
        ffn = D * self.n_experts + self.top_k * 3 * D * self.d_ff
        per_layer = attn + ffn + 2 * D
        emb = self.vocab_size * D * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + D


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: LMConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32) -> Dict:
    """Layer-stacked parameters (leading dim = n_layers) on the generator's
    device: normal weights scaled by fan_in ** -0.5 (the embedding by 1,
    ``w_down`` by d_ff ** -0.5, the router by d_model ** -0.5), ones for the
    norms, zeros for the biases.  The reference's initialiser with a
    ``torch.Generator`` for its key: the same distributions, not the same
    numbers.  The expert-stacked leaves (L, E, ...) are drawn one layer at a
    time in float32 and cast, so the temporary is one layer's."""
    L, D, hd = cfg.n_layers, cfg.d_model, cfg.head_dim
    Hq, Hkv, Fd, V = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size
    dev = generator.device

    def w(shape, scale=None):
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        s = scale if scale is not None else fan_in ** -0.5
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32).mul_(s).to(dtype)

    def per_layer(shape, scale=None):
        out = torch.empty(shape, dtype=dtype, device=dev)
        for i in range(shape[0]):
            out[i] = w(shape[1:], scale)
        return out

    def const(value, shape):
        return torch.full(shape, value, dtype=dtype, device=dev)

    layers = {
        "wq": w((L, D, Hq * hd)),
        "wk": w((L, D, Hkv * hd)),
        "wv": w((L, D, Hkv * hd)),
        "wo": w((L, Hq * hd, D)),
        "ln_attn": const(1.0, (L, D)),
        "ln_mlp": const(1.0, (L, D)),
    }
    if cfg.qkv_bias:
        layers["bq"] = const(0.0, (L, Hq * hd))
        layers["bk"] = const(0.0, (L, Hkv * hd))
        layers["bv"] = const(0.0, (L, Hkv * hd))
    if cfg.qk_norm:
        layers["q_norm"] = const(1.0, (L, hd))
        layers["k_norm"] = const(1.0, (L, hd))
    if cfg.is_moe:
        E = cfg.n_experts
        layers["router"] = w((L, D, E), scale=D ** -0.5)
        layers["w_gate"] = per_layer((L, E, D, Fd))
        layers["w_up"] = per_layer((L, E, D, Fd))
        layers["w_down"] = per_layer((L, E, Fd, D), scale=Fd ** -0.5)
    else:
        layers["w_gate"] = w((L, D, Fd))
        layers["w_up"] = w((L, D, Fd))
        layers["w_down"] = w((L, Fd, D), scale=Fd ** -0.5)

    params = {"embed": w((V, D), scale=1.0),
              "final_norm": const(1.0, (D,)), "layers": layers}
    if not cfg.tie_embeddings:
        params["lm_head"] = w((D, V))
    return params


def params_from_numpy(tree: Dict, cfg: LMConfig, device,
                      dtype: Optional[torch.dtype] = None) -> Dict:
    """The reference's parameter pytree, as numpy arrays (bfloat16 ones
    included), as the port's parameter dict on ``device``; ``dtype`` casts
    every leaf."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        t = (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
             if a.dtype.name == "bfloat16" else torch.from_numpy(a.copy()))
        return t.to(device=dev, dtype=dtype or t.dtype)

    out = {"embed": leaf(tree["embed"]),
           "final_norm": leaf(tree["final_norm"]),
           "layers": {k: leaf(v) for k, v in tree["layers"].items()}}
    if "lm_head" in tree:
        out["lm_head"] = leaf(tree["lm_head"])
    if cfg.tie_embeddings != ("lm_head" not in out):
        raise ValueError(f"{cfg.name}: tie_embeddings={cfg.tie_embeddings} "
                         "but the tree "
                         f"{'lacks' if 'lm_head' not in out else 'has'} "
                         "lm_head")
    return out


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """RMS norm in float32, cast back to x's dtype before the scale."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding, halves rotated: x (..., S, H, hd), positions
    (..., S)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq              # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _activation(gate: torch.Tensor, up: torch.Tensor, kind: str
                ) -> torch.Tensor:
    if kind == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    return F.silu(gate) * up


def dense_ffn(x: torch.Tensor, lw: Dict, cfg: LMConfig) -> torch.Tensor:
    h = _activation(x @ lw["w_gate"], x @ lw["w_up"], cfg.activation)
    return h @ lw["w_down"]


# ---------------------------------------------------------------------------
# MoE: sort-based capacity dispatch
# ---------------------------------------------------------------------------

def moe_capacity(n_tokens: int, cfg: LMConfig) -> int:
    """Slots per expert for ``n_tokens`` tokens: ``ceil(T * K / E * cf)``,
    at least 8 and at most T."""
    C = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))
    return max(8, min(C, n_tokens))


@dataclasses.dataclass
class MoERoute:
    """Where each (token, choice) assignment of G token groups goes."""
    top_e: torch.Tensor      # (G, Tg, K) int64: experts, highest gate first
    top_g: torch.Tensor      # (G, Tg, K) float32: renormalised gates
    slot: torch.Tensor       # (G, Tg, K) int64: e * C + rank, E * C dropped
    capacity: int            # C, slots per expert
    n_experts: int           # E

    @property
    def keep(self) -> torch.Tensor:
        """(G, Tg, K) bool: the assignments within their expert's
        capacity."""
        return self.slot < self.n_experts * self.capacity


def moe_route(xg: torch.Tensor, router: torch.Tensor, cfg: LMConfig
              ) -> MoERoute:
    """Route tokens ``xg`` (G, Tg, D): float32 softmax gates over the
    experts, the top K (ties to the lower expert) renormalised, then per
    group a stable sort of the flattened (token, choice) expert ids, each
    assignment's rank within its expert's run, and its buffer slot
    ``e * C + rank``, or the out-of-range ``E * C`` past the capacity C."""
    G, Tg, _ = xg.shape
    E, K = cfg.n_experts, cfg.top_k
    C = moe_capacity(Tg, cfg)
    gates = torch.softmax((xg @ router).float(), dim=-1)     # (G, Tg, E)
    top_g, top_e = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_g, top_e = top_g[..., :K], top_e[..., :K]
    top_g = top_g / top_g.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_e = top_e.reshape(G, Tg * K)
    order = torch.sort(flat_e, dim=-1, stable=True).indices
    se = flat_e.gather(1, order)
    idx = torch.arange(Tg * K, device=xg.device).expand(G, -1)
    run_start = torch.ones_like(se, dtype=torch.bool)
    run_start[:, 1:] = se[:, 1:] != se[:, :-1]
    base = torch.cummax(torch.where(run_start, idx, -1), dim=1).values
    rank = idx - base
    slot = torch.where(rank < C, se * C + rank, E * C)
    slot = torch.empty_like(slot).scatter_(1, order, slot)
    return MoERoute(top_e=top_e, top_g=top_g, slot=slot.view(G, Tg, K),
                    capacity=C, n_experts=E)


def _buffers(xe: torch.Tensor, grouped: bool) -> torch.Tensor:
    """The expert buffers (G, E, C, D) under their sharding rule: the
    grouped dispatch's ``moe_gecd``, or the single group's (E, C, D)
    ``moe_ecd``."""
    if grouped:
        return constrain(xe, "moe_gecd")
    return constrain(xe[0], "moe_ecd")[None]


def moe_experts(xg: torch.Tensor, lw: Dict, cfg: LMConfig, route: MoERoute,
                *, grouped: bool = False) -> torch.Tensor:
    """The experts of routed tokens ``xg`` (G, Tg, D): the kept assignments
    gathered into (G, E, C, D) buffers, the three expert products, and each
    token's kept outputs weighted by their gates and summed (its experts
    ascending, in the buffers' dtype) -> (G, Tg, D) in xg's dtype.
    ``grouped`` (the shard-local dispatch) selects the buffers' sharding
    rules."""
    G, Tg, D = xg.shape
    E, K, C = cfg.n_experts, cfg.top_k, route.capacity
    gi = torch.arange(G, device=xg.device)[:, None]
    slot = route.slot.reshape(G, Tg * K)
    # one spare row takes every dropped assignment and is cut off
    xe = xg.new_zeros((G, E * C + 1, D))
    xe[gi, slot] = xg.repeat_interleave(K, dim=1)
    xe = _buffers(xe[:, :E * C].reshape(G, E, C, D), grouped)
    h = _activation(torch.einsum("gecd,edf->gecf", xe, lw["w_gate"]),
                    torch.einsum("gecd,edf->gecf", xe, lw["w_up"]),
                    cfg.activation)
    del xe
    ye = torch.einsum("gecf,efd->gecd", h, lw["w_down"])
    if grouped:
        ye = constrain(ye, "moe_gecd")
    ye = ye.reshape(G, E * C, D)
    del h
    contrib = ye[gi, slot.clamp(max=E * C - 1)].view(G, Tg, K, D)
    contrib = contrib * route.top_g[..., None].to(ye.dtype)
    contrib = torch.where(route.keep[..., None], contrib, 0)
    # the reference's segment_sum adds a token's contributions in its
    # experts' sorted order, one rounding an addition
    by_expert = route.top_e.argsort(dim=-1)[..., None].expand(-1, -1, -1, D)
    contrib = contrib.gather(2, by_expert)
    y = contrib[:, :, 0]
    for k in range(1, K):
        y = y + contrib[:, :, k]
    return y.to(xg.dtype)


def moe_ffn(x: torch.Tensor, lw: Dict, cfg: LMConfig) -> torch.Tensor:
    """Sort-based capacity-bucketed MoE dispatch of x (T, D): assignments
    past an expert's capacity are dropped (GShard semantics).
    ``cfg.dispatch_groups > 1`` dispatches each of G token groups on its
    own (``_moe_ffn_grouped``)."""
    if cfg.dispatch_groups > 1:
        return _moe_ffn_grouped(x, lw, cfg)
    xg = x[None]
    return moe_experts(xg, lw, cfg, moe_route(xg, lw["router"], cfg))[0]


def _moe_ffn_grouped(x: torch.Tensor, lw: Dict, cfg: LMConfig
                     ) -> torch.Tensor:
    """Shard-local MoE dispatch: x (T, D) viewed as (G, T / G) groups, the
    capacity, sort and ranks per group."""
    T, D = x.shape
    xg = constrain(x.reshape(cfg.dispatch_groups, T // cfg.dispatch_groups,
                             D), "moe_tokens_g")
    y = moe_experts(xg, lw, cfg, moe_route(xg, lw["router"], cfg),
                    grouped=True)
    return y.reshape(T, D)


def _qkv(x: torch.Tensor, lw: Dict, cfg: LMConfig, positions: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Projected, normed and rotated q, k, v of x (B, S, D), each
    contiguous (B, H, S, hd)."""
    B, S, _ = x.shape
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ lw["wq"]
    k = x @ lw["wk"]
    v = x @ lw["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lw["bq"], k + lw["bk"], v + lw["bv"]
    q, k, v = fit_heads(q, Hq), fit_heads(k, Hkv), fit_heads(v, Hkv)
    q = q.reshape(B, S, Hq, hd)
    k = k.reshape(B, S, Hkv, hd)
    v = v.reshape(B, S, Hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, lw["q_norm"], cfg.norm_eps)
        k = rms_norm(k, lw["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return tuple(t.transpose(1, 2).contiguous() for t in (q, k, v))


#: the ``attn_impl`` choices: the reference's names; "ref" and "pallas" are
#: both the flash-attention op (kernel 10's registered operators for CUDA
#: tensors, attention_ref for CPU ones), "chunked" the reference's plain
#: online-softmax schedule
ATTN_IMPLS = ("ref", "pallas", "chunked")


def _attend(qt, kt, vt, cfg: LMConfig, window: int, attn_impl: str = "ref"):
    """Causal attention of one layer, (B, Hq, S, hd) -> (B, S, Hq * hd),
    through the flash-attention op or, for ``attn_impl="chunked"``,
    ``attention_chunked``."""
    fns = {"chunked": attention_chunked, "ref": flash_attention,
           "pallas": flash_attention}
    if attn_impl not in fns:
        raise ValueError(f"unknown attn_impl {attn_impl!r}; expected one of "
                         f"{ATTN_IMPLS}")
    o = local_heads(partial(fns[attn_impl], causal=True, window=window,
                            softcap=cfg.attn_softcap), qt, kt, vt)
    B, _, S, _ = o.shape
    return fit_heads(o.transpose(1, 2).reshape(
        B, S, cfg.n_heads * cfg.head_dim), cfg.n_heads)


def attention(x: torch.Tensor, lw: Dict, cfg: LMConfig,
              positions: torch.Tensor, *, local: bool,
              attn_impl: str = "ref") -> torch.Tensor:
    """One layer's attention block (training / prefill form): x (B, S, D)
    -> (B, S, D)."""
    qt, kt, vt = _qkv(x, lw, cfg, positions)
    window = cfg.sliding_window if local else 0
    return _attend(qt, kt, vt, cfg, window, attn_impl) @ lw["wo"]


def _ffn(x: torch.Tensor, lw: Dict, cfg: LMConfig) -> torch.Tensor:
    """The FFN half of a layer, residual included: the experts over the
    flattened tokens of x (B, S, D), or the dense FFN."""
    h = rms_norm(x, lw["ln_mlp"], cfg.norm_eps)
    if cfg.is_moe:
        return x + moe_ffn(h.reshape(-1, h.shape[-1]), lw,
                           cfg).view(h.shape)
    return x + dense_ffn(h, lw, cfg)


def _block(x: torch.Tensor, lw: Dict, cfg: LMConfig, positions: torch.Tensor,
           window: int, attn_impl: str = "ref") -> torch.Tensor:
    """One transformer block over x (B, S, D) with the layer's weights
    ``lw`` in the compute dtype: attention of the given window and the FFN,
    each with its residual."""
    h = rms_norm(x, lw["ln_attn"], cfg.norm_eps)
    x = x + attention(h, lw, cfg, positions, local=window > 0,
                      attn_impl=attn_impl)
    return constrain(_ffn(x, lw, cfg), "act_btd")


def _embed(embed: torch.Tensor, tokens: torch.Tensor, cfg: LMConfig
           ) -> torch.Tensor:
    """Token embeddings (B, S, D) in the compute dtype, scaled by
    sqrt(d_model) rounded to that dtype (the reference scales by a scalar
    of it) when ``cfg.embed_scale``."""
    x = fsdp_gather(embed)[tokens.long()].to(cfg.dtype)
    if tokens.dim() == 2:           # (B, S): the residual stream's rule
        x = constrain(x, "act_btd")
    if cfg.embed_scale:
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype))
    return x


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32,
                        device=tokens.device)[None].expand(B, S)


def _logits(x: torch.Tensor, final_norm: torch.Tensor, head: torch.Tensor,
            cfg: LMConfig) -> torch.Tensor:
    """The final norm and the LM head (``cfg.dtype``), with the final
    softcap: in place when nothing records a gradient (the (B, S, V)
    logits once), out of place otherwise."""
    x = rms_norm(x, final_norm.to(cfg.dtype), cfg.norm_eps)
    logits = constrain(x @ fsdp_gather(head).to(cfg.dtype), "logits")
    c = cfg.final_softcap
    if c > 0:
        if logits.requires_grad:
            return c * torch.tanh(logits / c)
        logits.div_(c).tanh_().mul_(c)
    return logits


# ---------------------------------------------------------------------------
# training: forward and loss over a parameter dict
# ---------------------------------------------------------------------------

#: the weight products the "dots" remat policy saves (``x @ w`` with a 2-D
#: weight dispatches to ``aten.mm``); batched products (``bmm``) recompute
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_kwargs(cfg: LMConfig) -> Dict:
    if cfg.remat_policy == "full":
        return {}
    if cfg.remat_policy == "dots":
        from torch.utils.checkpoint import \
            create_selective_checkpoint_contexts
        return {"context_fn": partial(create_selective_checkpoint_contexts,
                                      _save_dots)}
    raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; expected "
                     "'full' or 'dots'")


def _unit(cfg: LMConfig, attn_impl: str, names, first: int, positions,
          x: torch.Tensor, *weights: torch.Tensor) -> torch.Tensor:
    """Remat's unit: layers first, first + 1, ... over x, each from its
    stacked slices ``weights`` (``names`` order a layer), cast to the
    compute dtype inside, as the reference's scanned layer casts its
    slice."""
    n = len(names)
    for j in range(len(weights) // n):
        lw = {k: fsdp_gather(w).to(cfg.dtype)
              for k, w in zip(names, weights[j * n:(j + 1) * n])}
        x = _block(x, lw, cfg, positions, cfg.layer_window(first + j),
                   attn_impl)
    return x


def _cast_once(params: Dict, cfg: LMConfig) -> Dict:
    """``params`` with every leaf in ``cfg.dtype`` when
    ``cfg.cast_params_once`` (one cast a step, before the layers), else
    ``params``."""
    if not cfg.cast_params_once:
        return params
    out = {k: v.to(cfg.dtype) for k, v in params.items() if k != "layers"}
    out["layers"] = {k: v.to(cfg.dtype) for k, v in params["layers"].items()}
    return out


def _sublayers(cfg: LMConfig):
    """``[(layer, window), ...]`` in the order the forward runs them: each
    layer with its window, or the one-layer alternating stack's single
    layer twice, local then global (the reference's degenerate pair)."""
    if cfg.has_local and cfg.n_layers == 1:
        return [(0, cfg.sliding_window), (0, 0)]
    return [(i, cfg.layer_window(i)) for i in range(cfg.n_layers)]


def forward(params: Dict, tokens: torch.Tensor, cfg: LMConfig, *,
            attn_impl: str = "ref") -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, V) in ``cfg.dtype``, from the
    parameter dict ``params`` (the reference's pytree; leaves may require
    gradients).  Each layer, or an alternating stack's local/global pair,
    runs under ``torch.utils.checkpoint`` when ``cfg.remat`` is set; the
    one-layer alternating stack is one pair of its single layer."""
    from torch.utils.checkpoint import checkpoint

    params = _cast_once(params, cfg)
    x = _embed(params["embed"], tokens, cfg)
    positions = _positions(tokens)
    names = sorted(params["layers"])
    slices = [params["layers"][k].unbind(0) for k in names]
    step = 2 if cfg.has_local else 1
    remat_kw = _remat_kwargs(cfg) if cfg.remat else None
    for first in range(0, cfg.n_layers, step):
        weights = [s[i % cfg.n_layers] for i in range(first, first + step)
                   for s in slices]
        fn = partial(_unit, cfg, attn_impl, names, first, positions)
        if remat_kw is None:
            x = fn(x, *weights)
        else:
            x = checkpoint(fn, x, *weights, use_reentrant=False, **remat_kw)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return _logits(x, params["final_norm"], head, cfg)


def loss_fn(params: Dict, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: LMConfig, *, attn_impl: str = "ref") -> torch.Tensor:
    """Mean next-token cross-entropy: float32 logits, logsumexp minus the
    gold logit, averaged over (B, S), as the reference's ``loss_fn``."""
    logits = forward(params, tokens, cfg, attn_impl=attn_impl).float()
    if _is_dtensor(logits):
        return _vocab_parallel_loss(logits, labels)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _vocab_parallel_loss(logits, labels):
    """``loss_fn``'s value for vocab-sharded DTensor logits (the dry run on
    a mesh): PyTorch's vocab-parallel cross-entropy (``loss_parallel``),
    which keeps the logits and their gradient sharded as GSPMD keeps the
    reference's; a gather's backward would build the whole (B, S, V)
    gradient on every device."""
    import torch.nn.functional as F
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.parallel import loss_parallel

    B, S, V = logits.shape
    mesh = logits.device_mesh
    flat = logits.reshape(B * S, V)
    want = [Shard(1) if isinstance(p, Shard) and p.dim == 2 else
            Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in logits.placements]
    if not any(isinstance(p, Shard) and p.dim == 1 for p in want):
        want = list(flat.placements)
    flat = flat.redistribute(mesh, want)
    target = labels.reshape(B * S).long()
    if _is_dtensor(target):
        target = target.redistribute(mesh, [
            Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in flat.placements])
    with loss_parallel():
        total = F.cross_entropy(flat, target, reduction="sum")
    return total / (B * S)


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device="cuda") -> Dict:
    """KV cache, layer-stacked (L, batch, Hkv, slots, hd).  Alternating
    stacks add a ring buffer bounded by the sliding window for their local
    layers."""
    dev = resolve_device(device)
    Hkv, hd, L = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers

    def zeros(slots):
        return torch.zeros((L, batch, Hkv, slots, hd), dtype=dtype,
                           device=dev)

    cache = {"k": zeros(max_len), "v": zeros(max_len)}
    if cfg.has_local:
        w = min(cfg.sliding_window, max_len)
        cache["k_local"] = zeros(w)
        cache["v_local"] = zeros(w)
    return cache


def _decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                      pos: int, *, softcap: float, window: int, ring: bool
                      ) -> torch.Tensor:
    """q (B, Hq, 1, hd); ck/cv (B, Hkv, Smax, hd); pos the current position.
    Plain float32 attention over every slot of the cache, the ones not yet
    written (or outside the window) masked."""
    B, Hq, _, hd = q.shape
    Hkv, Smax = ck.shape[1], ck.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bkgd,bksd->bkgs", qg.float(), ck.float()) * hd ** -0.5
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    slots = torch.arange(Smax, device=q.device)
    if ring:
        valid = slots < min(pos + 1, Smax)
    else:
        valid = slots <= pos
        if window > 0:
            valid &= slots > pos - window
    s = torch.where(valid, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", p, cv.float())
    return o.reshape(B, Hq, 1, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class TransformerLM(nn.Module):
    """A decoder-only LM over the parameters ``params`` (from
    ``init_params`` or ``params_from_numpy``), for serving: the parameters
    take no gradient."""

    def __init__(self, cfg: LMConfig, params: Dict):
        super().__init__()
        self.cfg = cfg

        def frozen(t):
            return nn.Parameter(t, requires_grad=False)

        self.embed = frozen(params["embed"])
        self.final_norm = frozen(params["final_norm"])
        if cfg.tie_embeddings:
            self.register_parameter("lm_head", None)
        else:
            self.lm_head = frozen(params["lm_head"])
        unknown = set(params["layers"]) - set(LAYER_PARAMS)
        if unknown:
            raise ValueError(f"unknown layer parameters {sorted(unknown)}")
        self.layers = nn.ParameterDict(
            {k: frozen(v) for k, v in params["layers"].items()})

    # -- pieces ---------------------------------------------------------------
    def _layer(self, i: int, layers=None) -> Dict:
        layers = self.layers if layers is None else layers
        return {k: fsdp_gather(p[i]).to(self.cfg.dtype)
                for k, p in layers.items()}

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return _embed(self.embed, tokens, self.cfg)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """The final norm and LM head, without the final softcap."""
        cfg = self.cfg
        x = rms_norm(x, self.final_norm.to(cfg.dtype), cfg.norm_eps)
        head = self.embed.T if self.lm_head is None else self.lm_head
        return x @ fsdp_gather(head).to(cfg.dtype)

    def _ffn(self, x: torch.Tensor, lw: Dict) -> torch.Tensor:
        return _ffn(x, lw, self.cfg)

    # -- entry points ---------------------------------------------------------
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) int -> logits (B, S, V) in ``cfg.dtype``."""
        cfg = self.cfg
        x = self._embed(tokens)
        positions = _positions(tokens)
        for i, window in _sublayers(cfg):
            x = _block(x, self._layer(i), cfg, positions, window)
        head = self.embed.T if self.lm_head is None else self.lm_head
        return _logits(x, self.final_norm, head, cfg)

    def prefill(self, tokens: torch.Tensor, *, attn_impl: str = "ref"
                ) -> Tuple[torch.Tensor, Dict]:
        """Serving prefill: last-position logits (B, V) float32 and the KV
        cache {k, v}: (L, B, Hkv, S, hd) in ``cfg.dtype``; alternating
        stacks also fill the ring caches ``k_local``/``v_local`` with the
        last ``window`` positions of every layer (the one-layer alternating
        stack keeps its local sub-layer's).  With ``cfg.cast_params_once``
        the layer stack is cast to ``cfg.dtype`` once, up front.
        ``attn_impl`` as ``forward``'s."""
        cfg = self.cfg
        B, S = tokens.shape
        x = self._embed(tokens)
        positions = _positions(tokens)
        layers = self.layers
        if cfg.cast_params_once:
            layers = {k: p.to(cfg.dtype) for k, p in layers.items()}
        shape = (cfg.n_layers, B, cfg.n_kv_heads, S, cfg.head_dim)
        ks = torch.empty(shape, dtype=cfg.dtype, device=tokens.device)
        vs = torch.empty_like(ks)
        for j, (i, window) in enumerate(_sublayers(cfg)):
            lw = self._layer(i, layers)
            h = rms_norm(x, lw["ln_attn"], cfg.norm_eps)
            qt, kt, vt = _qkv(h, lw, cfg, positions)
            if j == 0:
                ks, vs = stacked_like(ks, kt), stacked_like(vs, vt)
            if j < cfg.n_layers:
                ks[j], vs[j] = kt, vt
                kt, vt = ks[j], vs[j]
            x = x + _attend(qt, kt, vt, cfg, window, attn_impl) @ lw["wo"]
            x = constrain(self._ffn(x, lw), "act_btd")
            del qt, kt, vt
        logits = self._head(x[:, -1]).float()
        if cfg.final_softcap > 0:
            logits = cfg.final_softcap * torch.tanh(
                logits / cfg.final_softcap)
        cache = {"k": ks, "v": vs}
        if cfg.has_local:
            w = min(cfg.sliding_window, S)
            cache["k_local"] = ks[:, :, :, S - w:].clone()
            cache["v_local"] = vs[:, :, :, S - w:].clone()
        return logits, cache

    def decode_step(self, cache: Dict, token: torch.Tensor, pos
                    ) -> Tuple[torch.Tensor, Dict]:
        """One token for every sequence of the batch: token (B,) int, pos
        the shared position (int or 0-d tensor).  Writes the token's key
        and value into ``cache`` in place (a local layer its ring slot
        ``pos % window``, any other layer slot ``pos``) and returns the
        logits (B, V) float32 and the cache."""
        cfg = self.cfg
        pos = int(pos)
        B = token.shape[0]
        x = self._embed(token)[:, None, :]                  # (B, 1, D)
        positions = torch.full((B, 1), pos, dtype=torch.int32,
                               device=token.device)
        for i in range(cfg.n_layers):
            lw = self._layer(i)
            h = rms_norm(x, lw["ln_attn"], cfg.norm_eps)
            qt, kt, vt = _qkv(h, lw, cfg, positions)       # (B, H, 1, hd)
            ring = cfg.has_local and i % 2 == 0
            names = ("k_local", "v_local") if ring else ("k", "v")
            ck, cv = cache[names[0]][i], cache[names[1]][i]
            slot = pos % ck.shape[2] if ring else pos
            ck[:, :, slot] = kt[:, :, 0]
            cv[:, :, slot] = vt[:, :, 0]
            o = _decode_attention(qt, ck, cv, pos, softcap=cfg.attn_softcap,
                                  window=cfg.layer_window(i), ring=ring)
            x = x + o.transpose(1, 2).reshape(B, 1, -1) @ lw["wo"]
            x = self._ffn(x, lw)
        logits = self._head(x[:, 0]).float()
        if cfg.final_softcap > 0:
            logits = cfg.final_softcap * torch.tanh(
                logits / cfg.final_softcap)
        return logits, cache
