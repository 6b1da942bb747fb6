"""Shard-axis exchanges of the sharded graph plane, stacked and collective;
and the gradient compressors of training.

Each exchange has two forms, as the reference's has a ``vmap`` and a
``shard_map`` rendering:

* the stacked form (``group=None``): the one-device rendering keeps every
  shard's vectors and buckets in one tensor with a leading shard axis, so
  the exchange is a reshape or a reduction over that axis;
* the collective form (``group=`` the mesh's ``"shard"`` process group):
  the multi-process rendering holds one shard a rank, and the exchange is
  a ``torch.distributed`` collective over the group, the counterpart of
  the reference's ``axis_name`` argument.

Gloo carries CUDA tensors through its all-to-all, all-gather and
all-reduce (it stages them through host memory itself) but not through
point-to-point sends, which read the device pointer on the host: the ring
pass (``ring_shift``) stages CUDA tensors through the host explicitly, for
gloo only.

The gradient compressors, from the reference's
``repro.distributed.collectives``: int8 quantization with a per-leaf scale
(``quantize_int8``, ``dequantize_int8``), error feedback (``compress_grads``
carries the quantization error into the next step's residual,
``init_residual``), the int8 all-reduce ``compressed_psum`` (scales
max-reduced so every rank dequantizes alike, the int8 values summed as
int32, the mean) and ``reduce_scatter_grads`` (ZeRO-1's wire pattern).
They take a parameter tree (nested dicts and tuples of tensors) and, for
the collectives, the process group in place of the reference's
``axis_name``.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.tree import tree_leaves, tree_map, tree_unflatten

#: this rank's collectives: calls, bytes it sent (all-to-all bytes apart),
#: and host-clock seconds inside the calls (a gloo call returns after its
#: transfer, an NCCL call once it is queued on the stream)
COLLECTIVE_STATS: Dict[str, float] = {"calls": 0, "bytes": 0,
                                      "all_to_all_bytes": 0, "seconds": 0.0}


def reset_collective_stats() -> None:
    for k in COLLECTIVE_STATS:
        COLLECTIVE_STATS[k] = 0


def _counted(fn, nbytes: int, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    COLLECTIVE_STATS["seconds"] += time.perf_counter() - t0
    COLLECTIVE_STATS["calls"] += 1
    COLLECTIVE_STATS["bytes"] += nbytes
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def exchange_buckets(buckets: torch.Tensor, group=None) -> torch.Tensor:
    """The all-to-all of per-owner routing buckets.

    Stacked: ``(n_src, n_owner, cap, ...)``, row ``i`` holding what source
    shard ``i`` routed to each owner, becomes ``(n_owner, n_src, cap,
    ...)``.  Collective: this rank's ``(n_owner, cap, ...)`` buckets
    become ``(n_src, cap, ...)``, row ``i`` what source rank ``i`` routed
    here (``all_to_all_single``, equal splits).  Either way an owner's
    rows list the sources in order, and each source routes one contiguous
    block of the batch, so flattening them keeps the global batch order,
    which the update engine's determinism rests on."""
    if group is None:
        return buckets.transpose(0, 1).contiguous()
    src = buckets.contiguous()
    out = torch.empty_like(src)
    _counted(dist.all_to_all_single, _nbytes(src), out, src, group=group)
    COLLECTIVE_STATS["all_to_all_bytes"] += _nbytes(src)
    return out


def gather_interleaved(x_local: torch.Tensor, n_global: int,
                       group=None) -> torch.Tensor:
    """Per-shard vertex vectors to the ``(V,)`` global order: vertex ``v``
    lives on shard ``v % S`` at local id ``v // S``, so the shard axis
    interleaves, and the tail padding of the last local row is trimmed
    when ``V % S != 0``.  Stacked: ``x_local`` is ``(S, n_local)``.
    Collective: it is this rank's ``(n_local,)``, all-gathered over the
    group, and every rank returns the same ``(V,)`` vector."""
    if group is not None:
        x_local = gather_stacked(x_local, group)
    return x_local.transpose(0, 1).reshape(-1)[:n_global]


def gather_stacked(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) stacked in rank order on a new
    leading axis, on every rank (an all-gather)."""
    x = x.contiguous()
    parts = [torch.empty_like(x)
             for _ in range(dist.get_world_size(group))]
    _counted(dist.all_gather, _nbytes(x), parts, x, group=group)
    return torch.stack(parts)


def or_across_shards(partial_mask: torch.Tensor, group=None) -> torch.Tensor:
    """Partial boolean results (each batch position owned by one shard) to
    the full ``(B,)`` mask.  Stacked: ``(S, B)`` reduced over the shard
    axis.  Collective: this rank's ``(B,)``, an all-reduce ``MAX`` on
    ``uint8`` (not on ``bool``, whose mapping the backends do not share),
    replicated on every rank."""
    if group is None:
        return partial_mask.any(dim=0)
    t = partial_mask.to(torch.uint8)
    _counted(dist.all_reduce, _nbytes(t), t, op=dist.ReduceOp.MAX,
             group=group)
    return t.bool()


def max_across_shards(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks (``x`` itself
    without a group): the overflow witness and the host bounds that every
    rank must agree on."""
    if group is None:
        return x
    t = x.clone()
    _counted(dist.all_reduce, _nbytes(t), t, op=dist.ReduceOp.MAX,
             group=group)
    return t


def sum_across_shards(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise sum of ``x`` over the ranks (``x`` itself without a
    group)."""
    if group is None:
        return x
    t = x.clone()
    _counted(dist.all_reduce, _nbytes(t), t, group=group)
    return t


def gather_objects(obj, group) -> list:
    """Every rank's picklable host object, in rank order, on every rank."""
    out: List[object] = [None] * dist.get_world_size(group)
    _counted(dist.all_gather_object, 0, out, obj, group=group)
    return out


def ring_shift(tensors: Sequence[torch.Tensor], group
               ) -> List[torch.Tensor]:
    """Pass ``tensors`` one step round the ring: every rank sends its own
    to rank ``r - 1`` and returns what rank ``r + 1`` sent (equal shapes
    and dtypes on every rank).  Gloo's point-to-point sends cannot read a
    CUDA tensor, so under gloo a CUDA tensor travels through a host copy
    (and comes back to the card); NCCL sends device memory."""
    S, r = dist.get_world_size(group), dist.get_rank(group)
    if S == 1:
        return [t.clone() for t in tensors]
    staged = (dist.get_backend(group) == "gloo"
              and any(t.is_cuda for t in tensors))
    send = [t.cpu() if staged else t.contiguous() for t in tensors]
    recv = [torch.empty_like(t) for t in send]
    to_rank = dist.get_global_rank(group, (r - 1) % S)
    from_rank = dist.get_global_rank(group, (r + 1) % S)
    ops = []
    for s, t in zip(send, recv):
        ops.append(dist.P2POp(dist.isend, s, to_rank, group))
        ops.append(dist.P2POp(dist.irecv, t, from_rank, group))
    t0 = time.perf_counter()
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    COLLECTIVE_STATS["seconds"] += time.perf_counter() - t0
    COLLECTIVE_STATS["calls"] += 1
    COLLECTIVE_STATS["bytes"] += sum(_nbytes(t) for t in send)
    if staged:
        return [t.to(src.device) for t, src in zip(recv, tensors)]
    return recv


# ----------------------------------------------------------------------------
# gradient compression: int8 with error feedback, and reduce-scatter
# ----------------------------------------------------------------------------

def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)``: x / scale rounded half to even and clipped to
    [-127, 127] as int8, scale = max|x| / 127 + 1e-12 (0-d float32)."""
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads(grads: Any, residual: Any) -> Tuple[Any, Any, Any]:
    """Quantize ``grads + residual`` leaf by leaf: ``(q, scales,
    new_residual)``, the residual the quantization error."""
    def one(g, r):
        t = g.float() + r
        q, s = quantize_int8(t)
        return q, s, t - dequantize_int8(q, s)

    out = [one(g, r) for g, r in zip(tree_leaves(grads),
                                    tree_leaves(residual))]
    return tuple(tree_unflatten(grads, [o[i] for o in out])
                 for i in range(3))


def init_residual(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_psum(grads: Any, residual: Any, group=None
                    ) -> Tuple[Any, Any]:
    """The int8 all-reduce over ``group`` (the default group when None):
    each leaf's scale max-reduced over the ranks (one all-reduce for all
    leaves), ``grads + residual`` requantized against it, the int8 values
    summed as int32 and dequantized, divided by the group size.  Returns
    ``(mean gradients, new residual)``."""
    _, scales, _ = compress_grads(grads, residual)
    s = torch.stack(tree_leaves(scales))
    _counted(dist.all_reduce, _nbytes(s), s, op=dist.ReduceOp.MAX,
             group=group)
    n = dist.get_world_size(group)
    means, res = [], []
    for g, r, sc in zip(tree_leaves(grads), tree_leaves(residual),
                        s.unbind(0)):
        t = g.float() + r
        qq = torch.clamp(torch.round(t / sc), -127, 127).to(torch.int8)
        res.append(t - qq.float() * sc)
        summed = qq.to(torch.int32)
        _counted(dist.all_reduce, _nbytes(summed), summed,
                 op=dist.ReduceOp.SUM, group=group)
        means.append(summed.float() * sc / n)
    return tree_unflatten(grads, means), tree_unflatten(grads, res)


def reduce_scatter_grads(grads: Any, group=None,
                         num_shards: Optional[int] = None) -> Any:
    """Reduce-scatter each gradient leaf along its leading dim over
    ``group`` (``dist.reduce_scatter_tensor``: rank r keeps rows [r n / S,
    (r + 1) n / S) of the sum); a 0-d leaf, or one whose leading dim
    ``num_shards`` (the group size when None) does not divide, is
    all-reduced whole.  A backend without reduce-scatter raises; there is
    no fallback."""
    S = dist.get_world_size(group) if num_shards is None else num_shards

    def one(g):
        if g.dim() == 0 or g.shape[0] % S:
            out = g.clone()
            _counted(dist.all_reduce, _nbytes(out), out,
                     op=dist.ReduceOp.SUM, group=group)
            return out
        out = g.new_empty((g.shape[0] // S,) + tuple(g.shape[1:]))
        _counted(dist.reduce_scatter_tensor, _nbytes(g), out,
                 g.contiguous(), op=dist.ReduceOp.SUM, group=group)
        return out
    return tree_map(one, grads)


__all__ = ["COLLECTIVE_STATS", "reset_collective_stats",
           "exchange_buckets", "gather_interleaved", "or_across_shards",
           "gather_stacked", "max_across_shards", "sum_across_shards",
           "gather_objects", "ring_shift", "quantize_int8",
           "dequantize_int8", "compress_grads", "init_residual",
           "compressed_psum", "reduce_scatter_grads"]
