"""Dry run, from ``repro.launch.dryrun``: trace every (architecture x
input-shape) cell's step on the production meshes, and record its memory,
cost and collectives per device.

PyTorch has no XLA cost analysis.  Each cell's step is traced once under
``FakeTensorMode`` (nothing is allocated, nothing runs), with its
parameters and inputs as DTensors on the mesh laid out by the cell's spec
trees (``launch.steps.make_cell``), inside ``sharding_rules`` so the
models' ``constrain`` calls redistribute.  One dispatch mode
(``Trace``) sees every operator the devices would run, at the local
(per-device) level: it lets DTensor turn each global operator into its
local operators and collectives first, and skips the global-shape
operators DTensor runs to infer output shapes.  From those it takes

* **flops**: ``torch.utils.flop_counter.FlopCounterMode``'s formulas
  (registered ones included, e.g. kernel 10's) on the local operators:
  one device's share, redundant compute included;
* **bytes accessed**: each operator's input and output bytes, views and
  allocations excluded, a gather counting the rows it reads and a scatter
  the rows it writes (not the whole table).  Operators are not fused, so
  this is about what eager PyTorch moves: an upper bound on the HBM
  traffic of a program that fuses, never a floor (``launch.roofline``'s
  ``bound_s`` does not use it);
* **peak bytes**: each new storage's bytes added when an operator makes
  it and taken away when it is freed, on top of the arguments' bytes;
* **collectives**: count and output bytes of each kind among the
  ``c10d_functional`` operators (all-reduce, all-gather, reduce-scatter,
  all-to-all).

The records keep the reference's JSON fields: ``memory.{argument,output,
temp}_bytes`` (temp: the peak above the arguments), ``cost.{flops,
bytes_accessed}``, ``collectives`` with ``count``/``bytes`` per kind and
``total_bytes``, ``cost_calibrated`` (see below),
``cost_single_device`` (GNN and recsys: the same step traced with no mesh),
``n_devices`` and ``ok``/``skipped``/``error``.

``mesh_kind`` is ``"pod"`` (16 x 16), ``"multipod"`` (2 x 16 x 16, traced
as its 32 x 16 rendering, ``_pods_merged``) or ``"single"`` (no mesh:
plain fake tensors, one device).  ``attn_impl`` "ref" traces an LM cell
on CPU fake tensors, where the flash-attention op is the plain
``attention_ref``; "kernel" (``"single"`` only, on a CUDA build of torch)
moves the cell's fake arguments to the CUDA device, so the step takes the
card's path: kernel 10 and its backward as the registered operators
``repro_torch::flash_attention_{fwd,bwd}`` that the card launches.  The production
meshes live on a fake process group of 256 or 512 ranks
(``launch.mesh.production_mesh``), created and destroyed around each
cell.  An operator that DTensor cannot partition (no sharding strategy,
as the segment max's ``scatter_reduce``, or a propagation that fails) runs
as GSPMD runs one: its operands gathered in full on every device, the
gathers counted (``Trace._replicated``; the record's ``replicated``
lists them).  The GNN cells trace on the mesh flattened to one dim
(``_flattened``: their tables split over every axis at once), and the
models' layout helpers (``distributed.sharding``'s ``fsdp_gather``,
``local_heads``, ``fit_heads``) give DTensor the layouts GSPMD would
pick.  The fake group's mesh is a ``"cpu"`` mesh on a machine without
CUDA, where DTensor would replace an all-to-all by an all-gather and a
chunk: the trace asks for the all-to-all a CUDA mesh runs.

On a mesh DTensor's sharding propagation costs about a millisecond an
operator, so an LM cell there is traced at two depths (1 and 2 layers, or
2 and 4 for an alternating stack), each with the cell's microbatches, and
every count is extrapolated linearly to the full depth: the record's
``cost``, ``memory`` and ``collectives`` are the extrapolated ones,
``cost_calibrated`` repeats its cost and ``calibrated_from_layers`` names
the depths.  (The reference calibrates because XLA's cost analysis counts
a scanned body once; the port's layer loop is a Python loop that the
counter counts in full, which ``"single"`` does: no calibration there.)

The graph plane's cells (``meerkat-graph``) read the host inside their
steps, which a fake trace cannot: ``run_cell`` runs them for real on the
stacked four-shard plane, on the card unless the caller names the CPU
(``--device cpu``; it raises without a card, as the serve and the
trainer do), and records the measured seconds and peak bytes
(``"measured": true``, with ``"device"``; a CPU record's file name ends
in ``__cpu``).  ``--all`` is the 40 assigned cells, as in the reference.

Usage:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
      --shape train_4k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --device cpu       # on a machine without a card

Writes one JSON a cell under ``experiments/dryrun_torch/``, which
``launch.roofline`` reads.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Dict

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: c10d_functional (and DTensor) operator -> collective kind
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
}

#: operators that move no bytes of their own
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh",
               "_to_copy_meta", "wait_tensor", "device", "_local_scalar_dense",
               "set_", "resize_", "sym_size", "sym_stride", "sym_numel",
               "is_same_size", "_has_compatible_shallow_copy_type",
               "_unsafe_view", "broadcast"}

#: gathers: the rows read (the output's bytes) stand for the table's
_GATHERS = {"index", "index_select", "embedding", "gather", "take",
            "take_along_dim"}
#: in-place scatters: the source read, its rows read and written in self
_SCATTERS = {"index_put_", "index_add_", "scatter_", "scatter_add_",
             "scatter_reduce_", "index_copy_", "_index_put_impl_"}

OPT_BUNDLES = ("moe_local", "chunked_attn", "gnn_fshard", "eq_bf16",
               "mind_localneg", "bf16_gather", "mb1", "mb2", "mb4",
               "eq_chunk", "mind_bf16", "remat_dots", "eq_trunc")


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _tensors(tree):
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


#: > 0 while DTensor infers an output's global shape
_INFERRING = [0]


class Trace(TorchDispatchMode):
    """Counts what the device would run: flops, bytes accessed, the peak
    of the live storages and the collectives, over the operators on fake
    tensors (see the module docstring).  ``track(tree)`` adds the
    arguments' storages before the step."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self.counter = FlopCounterMode(display=False)
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, object] = {}
        self.collectives = {k: {"count": 0, "bytes": 0}
                            for k in COLLECTIVES}
        #: calls of the port's own registered operators (kernel 10)
        self.custom_ops: Dict[str, int] = {}
        #: global operators DTensor could not partition, run replicated
        self.replicated: Dict[str, int] = {}
        self._depth = 0

    # -- storages ------------------------------------------------------------
    def _add(self, t: torch.Tensor) -> None:
        from torch.distributed.tensor import DTensor
        if isinstance(t, DTensor):
            t = t._local_tensor
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)

        def freed(key=key, n=n, ref=weakref.ref(self)):
            me = ref()
            if me is not None:
                me.live -= n
                me._storages.pop(key, None)
        self._storages[key] = weakref.finalize(st, freed)

    def track(self, tree) -> int:
        """Add the storages of ``tree``'s tensors; their bytes."""
        before = self.live
        for t in _tensors(tree):
            self._add(t)
        return self.live - before

    @property
    def flops(self) -> int:
        return int(self.counter.get_total_flops())

    # -- the mode ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self._depth:
                # inside our own attempt: let DTensor turn the global
                # operator into its local ones and its collectives, which
                # come back through this mode
                return NotImplemented
            self._depth += 1
            try:
                with self:
                    return func(*args, **kwargs)
            except Exception:
                pass        # no sharding strategy, or its propagation failed
            finally:
                self._depth -= 1
            return self._replicated(func, args, kwargs)
        out = func(*args, **kwargs)
        if _INFERRING[0]:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not any(isinstance(t, FakeTensor) for t in ins + outs):
            # DTensor's shape inference on global meta tensors
            return out
        packet = func._overloadpacket
        name = packet.__name__
        if str(func).startswith("repro_torch."):
            self.custom_ops[str(func)] = self.custom_ops.get(str(func), 0) + 1
        self.counter._count_flops(packet, out, args, kwargs)
        kind = _COLLECTIVE_OPS.get(name)
        if kind is not None:
            self.collectives[kind]["count"] += 1
            self.collectives[kind]["bytes"] += sum(map(_nbytes, outs))
        elif not (func.is_view or name in _NO_TRAFFIC):
            self.bytes_accessed += self._traffic(name, ins, outs)
        for t in outs:
            if isinstance(t, FakeTensor):
                self._add(t)
        return out

    def _replicated(self, func, args, kwargs):
        """What GSPMD does with an operator it cannot partition: every
        operand gathered in full on every device (an all-gather of each
        sharded one, an all-reduce of each partial one, counted here), the
        operator run on the full tensors, its outputs replicated.  An
        in-place operator returns its DTensor operand as it was (the trace
        keeps shapes, not values)."""
        from torch.distributed.tensor import DTensor, Replicate
        from torch.distributed.tensor._dtensor_spec import (DTensorSpec,
                                                            TensorMeta)

        self.replicated[str(func)] = self.replicated.get(str(func), 0) + 1
        mesh = next(t.device_mesh for t in pytree.tree_leaves((args, kwargs))
                    if isinstance(t, DTensor))

        def full(t):
            if not isinstance(t, DTensor):
                return t
            nbytes = t.numel() * t.element_size()
            if any(p.is_shard() for p in t.placements):
                self.collectives["all-gather"]["count"] += 1
                self.collectives["all-gather"]["bytes"] += nbytes
            if any(p.is_partial() for p in t.placements):
                self.collectives["all-reduce"]["count"] += 1
                self.collectives["all-reduce"]["bytes"] += nbytes
            return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                       device=t._local_tensor.device)
        l_args, l_kwargs = pytree.tree_map(full, (args, kwargs))
        with self:
            out = func(*l_args, **l_kwargs)
        if func._schema.is_mutable and isinstance(args[0], DTensor):
            return args[0]

        def wrap(t):
            if not isinstance(t, torch.Tensor):
                return t
            spec = DTensorSpec(mesh, (Replicate(),) * mesh.ndim,
                               tensor_meta=TensorMeta(t.shape, t.stride(),
                                                      t.dtype))
            return DTensor(t, spec, requires_grad=False)
        return pytree.tree_map(wrap, out)

    @staticmethod
    def _traffic(name: str, ins, outs) -> int:
        if name in _GATHERS and ins:
            # the rows read stand for the table
            return sum(map(_nbytes, ins[1:])) + 2 * sum(map(_nbytes, outs))
        if name in _SCATTERS and len(ins) >= 2:
            src = max(ins[1:], key=_nbytes)
            return sum(map(_nbytes, ins[1:])) + 2 * _nbytes(src)
        return sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))

    def result(self) -> dict:
        coll = {k: dict(v) for k, v in self.collectives.items()}
        coll["total_bytes"] = sum(v["bytes"] for v in self.collectives
                                  .values())
        by_op = {str(k): int(v) for k, v in
                 self.counter.get_flop_counts().get("Global", {}).items()
                 if v}
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "peak": self.peak, "collectives": coll,
                "replicated": dict(self.replicated), "flops_by_op": by_op,
                "custom_ops": dict(self.custom_ops)}


@contextlib.contextmanager
def _cuda_alltoall():
    """DTensor's shard-to-shard redistribution as a CUDA mesh runs it (one
    all-to-all), also on a ``"cpu"`` mesh, where DTensor would fall back to
    an all-gather and a chunk."""
    import torch.distributed._functional_collectives as funcol
    import torch.distributed.tensor.placement_types as pt

    real = pt.shard_dim_alltoall

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = funcol._resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, funcol._group_or_group_name(group))
    pt.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        pt.shard_dim_alltoall = real


@contextlib.contextmanager
def _cached_propagation():
    """DTensor treats any running ``FakeTensorMode`` as a compiler's trace
    (symbolic shapes) and skips its sharding-propagation and
    redistribution caches.  The dry run's shapes are static, so inside,
    DTensor's modules see no trace and reuse their caches: a stack of
    identical layers propagates each operator once."""
    import importlib

    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    mods = []
    for name in ("_sharding_prop", "_collective_utils", "_redistribute",
                 "placement_types", "_decompositions", "_dispatch"):
        try:
            mod = importlib.import_module(f"torch.distributed.tensor.{name}")
        except ImportError:
            continue
        if "_are_we_tracing" in vars(mod):
            mods.append((mod, vars(mod)["_are_we_tracing"]))
    for mod, _ in mods:
        mod._are_we_tracing = lambda: False
    # DTensor infers each output's global shape by running the operator
    # on global fake tensors: none of that is the devices' work
    infer = ShardingPropagator.__dict__["_propagate_tensor_meta_non_cached"]

    def inferring(self, *a, **kw):
        _INFERRING[0] += 1
        try:
            return infer(self, *a, **kw)
        finally:
            _INFERRING[0] -= 1
    ShardingPropagator._propagate_tensor_meta_non_cached = inferring
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = infer
        for mod, fn in mods:
            mod._are_we_tracing = fn


@contextlib.contextmanager
def _host_shard_math():
    """DTensor's strided-shard size arithmetic builds index tensors; under
    the dry run's ``FakeTensorMode`` they would be fake and their
    ``tolist()`` fails.  Inside, that arithmetic runs on real host tensors,
    outside every mode, once for each distinct question."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor.placement_types import _StridedShard

    real = {n: _StridedShard.__dict__[n]
            for n in ("local_shard_size_and_offset",
                      "_local_shard_size_and_offset")
            if n in _StridedShard.__dict__}

    from torch.utils._python_dispatch import _disable_current_modes

    def on_host(fn):
        cache = {}

        def wrapped(*a, **kw):
            key = (a, tuple(sorted(kw.items())))
            try:
                hit = key in cache
            except TypeError:            # an unhashable argument
                key, hit = None, False
            if hit:
                return cache[key]
            with unset_fake_temporarily(), _disable_current_modes():
                out = fn(*a, **kw)
            if key is not None:
                cache[key] = out
            return out
        return wrapped
    for n, fn in real.items():
        setattr(_StridedShard, n, on_host(fn))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(_StridedShard, n, fn)


def _distribute(tree, specs, mesh):
    """``tree``'s tensors as DTensors laid out by the matching ``specs``
    (a ``None`` spec: replicated); other leaves as they are."""
    import dataclasses as dc

    from ..distributed.sharding import P, distribute

    if isinstance(tree, torch.Tensor):
        spec = specs if isinstance(specs, P) else P()
        return distribute(tree, mesh, P(*spec[:tree.dim()]))
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _distribute(v, specs[k] if isinstance(specs, dict)
                               else specs, mesh) for k, v in tree.items()}
    if dc.is_dataclass(tree) and not isinstance(tree, type):
        return dc.replace(tree, **{
            f.name: _distribute(getattr(tree, f.name),
                                getattr(specs, f.name, None), mesh)
            for f in dc.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_distribute(v, s, mesh)
                            for v, s in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_distribute(v, s, mesh)
                          for v, s in zip(tree, specs))
    return tree


FLAT_AXIS = "devices"


def _flattened(mesh, spec_trees):
    """``(flat mesh, spec trees, rules)`` for the GNN cells, whose specs
    and rules either replicate a dim or split it over all of ``mesh``'s
    axes jointly (node and edge tables over the whole mesh, parameters
    replicated): the same layout on the flat 1-D mesh, where DTensor's view
    arithmetic on a dim split by several mesh dims (strided shards, which
    it handles slowly or not at all) is avoided.  The one spec over a part
    of the axes, the per-graph targets' ``P(dp)`` (a few hundred floats),
    is replicated there.  None when a spec splits a dim otherwise."""
    from ..distributed.sharding import P, default_rules

    axes = tuple(mesh.mesh_dim_names)

    def flat(spec):
        if spec is None or not isinstance(spec, P):
            return spec
        out = []
        for e in spec:
            if e is None:
                out.append(None)
            elif (e,) == axes or tuple(e) == axes:
                out.append(FLAT_AXIS)
            elif set((e,) if isinstance(e, str) else e) < set(axes):
                out.append(None)
            else:
                raise ValueError(spec)
        return P(*out)

    def walk(tree):
        if isinstance(tree, P) or tree is None:
            return flat(tree)
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
            return dataclasses.replace(tree, **{
                f.name: walk(getattr(tree, f.name))
                for f in dataclasses.fields(tree)})
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(walk(v) for v in tree))
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return tree

    try:
        specs = walk(spec_trees)
    except ValueError:
        return None
    rules = {}
    for name, spec in default_rules(mesh).items():
        try:
            rules[name] = flat(spec)
        except ValueError:
            rules[name] = None       # not a GNN rule: left out
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        return mesh._flatten(FLAT_AXIS), specs, rules


def trace_step(step, args, *, mesh=None, spec_trees=None,
               rule_overrides=None, flatten: bool = False) -> dict:
    """Run ``step(*args)`` (fake tensors, made under the running
    ``FakeTensorMode``) under ``Trace``: on ``mesh`` with the arguments
    distributed by ``spec_trees`` and the rules context on (on the mesh
    flattened to one dim with ``flatten``, see ``_flattened``), or on one
    device.  -> ``Trace.result()`` with ``argument_bytes`` and
    ``output_bytes``."""
    from ..distributed.sharding import sharding_rules

    ctx = contextlib.ExitStack()
    if flatten and mesh is not None and mesh.ndim > 1 \
            and not rule_overrides:
        flat = _flattened(mesh, spec_trees)
        if flat is not None:
            mesh, spec_trees, rule_overrides = flat
    if mesh is not None:
        from torch.distributed.tensor.experimental import \
            implicit_replication
        args = tuple(_distribute(a, s, mesh)
                     for a, s in zip(args, spec_trees))
        ctx.enter_context(sharding_rules(mesh, rule_overrides))
        ctx.enter_context(implicit_replication())
        ctx.enter_context(_cuda_alltoall())
        ctx.enter_context(_host_shard_math())
        ctx.enter_context(_cached_propagation())
    trace = Trace()
    with ctx:
        arg_bytes = trace.track(args)
        with trace:
            out = step(*args)
        out_bytes = sum(_nbytes(t if not hasattr(t, "_local_tensor")
                                else t._local_tensor) for t in _tensors(out)
                        if t.untyped_storage()._cdata not in
                        {a.untyped_storage()._cdata
                         for a in _tensors(args)})
    res = trace.result()
    del out
    res.update(argument_bytes=arg_bytes, output_bytes=out_bytes)
    return res


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def _pods_merged(mesh):
    """The multi-pod mesh as a ("data", "model") mesh of (pod x data) x
    model = 32 x 16 over the same ranks.  Every spec and rule splits over
    "pod" and "data" together (``dp_axes``), major first, so each tensor
    lays out the same on it; DTensor's propagation costs a 2-D mesh's
    there, not a 3-D one's (tens of minutes a cell)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.device_mesh import init_device_mesh

    pods, data, model = mesh.shape
    with unset_fake_temporarily():
        return init_device_mesh(mesh.device_type, (pods * data, model),
                                mesh_dim_names=("data", "model"))


def _extrapolated(a: dict, b: dict, layers, L: int) -> dict:
    """``trace_step`` results at depths ``layers`` = (la, lb) extrapolated
    linearly to ``L`` layers: x(L) = x(la) + (L - la) / (lb - la) x
    (x(lb) - x(la)), for every count (flops, bytes, peak, collectives)."""
    la, lb = layers
    k = (L - la) / (lb - la)

    def ext(x, y):
        return int(round(x + k * (y - x)))
    coll = {kind: {"count": ext(a["collectives"][kind]["count"],
                                b["collectives"][kind]["count"]),
                   "bytes": ext(a["collectives"][kind]["bytes"],
                                b["collectives"][kind]["bytes"])}
            for kind in COLLECTIVES}
    coll["total_bytes"] = sum(v["bytes"] for v in coll.values())
    out = {key: ext(a[key], b[key]) for key in
           ("flops", "bytes_accessed", "peak", "argument_bytes",
            "output_bytes")}
    out.update(collectives=coll, replicated=dict(b["replicated"]),
               flops_by_op={k: ext(a["flops_by_op"].get(k, 0), v)
                            for k, v in b["flops_by_op"].items()},
               custom_ops={k: ext(a["custom_ops"].get(k, 0), v)
                           for k, v in b["custom_ops"].items()})
    return out


def _opt_overrides(opts, m, mesh_size_dp: int):
    """(cfg_overrides, attn_impl or None, lm_micro or None, rule overrides,
    eq_chunk) for the reference's optimisation bundles."""
    from ..distributed.sharding import P
    cfg_overrides, rules, attn, micro = {}, {}, None, None
    if "moe_local" in opts:
        cfg_overrides["dispatch_groups"] = mesh_size_dp
    if "chunked_attn" in opts:
        attn = "chunked"
    if "gnn_fshard" in opts:
        rules["gnn_h"] = P(("data",), "model", None)
    if "eq_bf16" in opts:
        cfg_overrides["compute_dtype"] = torch.bfloat16
    if "mind_localneg" in opts:
        cfg_overrides["neg_groups"] = mesh_size_dp
    if "bf16_gather" in opts:
        cfg_overrides["cast_params_once"] = True
    if "mind_bf16" in opts:
        cfg_overrides["routing_dtype"] = "bf16"
    if "remat_dots" in opts:
        cfg_overrides["remat_policy"] = "dots"
    if "eq_trunc" in opts:
        cfg_overrides["trunc_rotation"] = True
    for o in opts:
        if o.startswith("mb"):
            micro = int(o[2:])
    return cfg_overrides, attn, micro, rules, "eq_chunk" in opts


def _graph_cell(arch, shape_name, rec, *, overrides=None, device="cuda",
                seed: int = 0) -> dict:
    """Run a ``meerkat-graph`` cell's step for real on the stacked
    four-shard plane on ``device`` (the card unless the caller names the
    CPU; raises for "cuda" without a card): a seeded batch of random edges
    for ``graph_update``; for ``graph_pagerank``, 20 warm-started
    iterations over the graph a seeded batch of that size builds (set-up,
    untimed).  Records seconds and peak bytes (CUDA), ``"measured": true``
    and the device."""
    from ..configs import get_arch
    from ..core.device import resolve_device
    from ..kernels import runtime
    from .steps import graph_cell

    m = get_arch(arch)
    shape = dict(m.SHAPES[shape_name])
    if overrides:
        shape.update(overrides)
    dev = resolve_device(device)
    V = shape["n_vertices"]
    B = shape.get("batch", 10240)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    src = torch.randint(0, V, (B,), generator=gen, dtype=torch.int32)
    dst = torch.randint(0, V, (B,), generator=gen, dtype=torch.int32)
    step, args, _ = graph_cell(m.full_config(), shape, None, device=dev)
    sg = args[0]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if shape["kind"] == "graph_update":
        call = (sg, src.to(dev), dst.to(dev))
    else:
        from ..distributed.sharded_graph import insert_edges_sharded
        # the in-edge view: dst -> src rows, out-degree of the sources
        sg, _ = insert_edges_sharded(sg, dst.to(dev), src.to(dev))
        out_degree = torch.bincount(src.long(), minlength=V).to(
            torch.int32).to(dev)
        call = (sg, out_degree, torch.full((V,), 1.0 / V, device=dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    runtime.reset_launches()
    t0 = time.perf_counter()
    out = step(*call)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in runtime.LAUNCHES.items() if v}
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    arg_bytes = sum(_nbytes(t) for t in _tensors(
        [getattr(call[0].graphs, f.name)
         for f in dataclasses.fields(call[0].graphs)]) ) + \
        sum(_nbytes(t) for t in call[1:])
    result = {}
    if shape["kind"] == "graph_update":
        result["inserted"] = int(out[1].sum())
    else:
        result["iterations"] = int(out[1])
        result["pr_sum"] = float(out[0].sum())
    rec.update(ok=True, measured=True, device=str(dev), seconds=seconds,
               n_devices=1, n_shards=args[0].n_shards,
               memory={"argument_bytes": arg_bytes,
                       "output_bytes": 0,
                       "temp_bytes": (peak - base) if peak is not None
                       else None,
                       "peak_bytes": peak},
               launches=launches, result=result)
    return rec


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             donate: bool = True, overrides=None, attn_impl: str = "ref",
             verbose: bool = True, calibrate: bool = True, opts=(),
             param_dtype: torch.dtype = torch.float32,
             device: str = "cuda") -> dict:
    """Trace one cell on ``mesh_kind`` ("pod", "multipod" or "single") and
    return its record.  ``overrides`` update the shape; ``opts`` are the
    reference's optimisation bundles; ``attn_impl`` "ref" traces an LM
    step on CPU fake tensors (the plain attention), "kernel" on CUDA fake
    tensors (``"single"`` only: the card's path, kernel 10's registered
    operators).  ``param_dtype`` is an LM's parameter dtype.  ``device`` is
    where a graph cell runs (the card unless the caller names the CPU).
    ``donate`` is the reference's (the port's LM and MIND steps update in
    place)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..configs import get_arch
    from ..distributed.sharding import P, dp_axes
    from .mesh import production_mesh
    from .steps import make_cell

    t0 = time.time()
    shapes = {"pod": [16, 16], "multipod": [2, 16, 16], "single": [1]}
    if mesh_kind not in shapes:
        raise ValueError(f"unknown mesh_kind {mesh_kind!r}")
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "mesh_shape": shapes[mesh_kind], "ok": False}
    if attn_impl not in ("ref", "kernel"):
        raise ValueError(f"unknown attn_impl {attn_impl!r}; expected 'ref' "
                         "or 'kernel'")
    m = get_arch(arch)
    skip = m.SKIP.get(shape_name)
    if skip:
        rec.update(ok=True, skipped=skip)
        return rec
    if m.FAMILY == "graph":
        return _graph_cell(arch, shape_name, rec, overrides=overrides,
                           device=device)

    n_dev = 1
    for s in shapes[mesh_kind]:
        n_dev *= s
    dp_size = {"pod": 16, "multipod": 32, "single": 1}[mesh_kind]
    cfg_overrides, attn, micro, rules, eq_chunk = _opt_overrides(
        opts, m, dp_size)
    attn_impl = attn or attn_impl
    on_card = attn_impl == "kernel" and m.FAMILY == "lm"
    if on_card and mesh_kind != "single":
        raise ValueError("attn_impl='kernel' traces on 'single': the fake "
                         "process group's meshes are CPU meshes")
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("attn_impl='kernel' traces the step on CUDA fake "
                           "tensors and needs a CUDA build of torch with a "
                           "card; use attn_impl='ref' here")
    rec["opts"] = sorted(opts)
    overrides = dict(overrides or {})
    if eq_chunk:
        # pad E up to a whole number of 2M-edge blocks
        blk = 2 * 1024 * 1024
        K = max(1, -(-m.SHAPES[shape_name].get("n_edges", 0) // blk))
        overrides["n_edges"] = K * blk
        cfg_overrides["edge_chunks"] = K

    mesh_ctx = (contextlib.nullcontext(None) if mesh_kind == "single" else
                production_mesh(multi_pod=mesh_kind == "multipod"))
    model_attn = "ref" if attn_impl == "kernel" else attn_impl

    def traced(mesh, **cell_kw):
        with FakeTensorMode(allow_non_fake_inputs=True):
            step, args, specs = make_cell(
                arch, shape_name, mesh, attn_impl=model_attn,
                overrides=overrides, cfg_overrides=cfg_overrides,
                lm_micro=micro, param_dtype=param_dtype, **cell_kw)
            if on_card:
                from ..core.tree import tree_map
                args = tree_map(lambda t: t.to("cuda"), args)
            return trace_step(step, args, mesh=mesh, spec_trees=specs,
                              rule_overrides=rules,
                              flatten=m.FAMILY == "gnn")

    calibrated = layers = None
    with mesh_ctx as mesh:
        if mesh is not None and mesh.ndim == 3:
            mesh = _pods_merged(mesh)
        t_build = time.time() - t0
        if mesh is not None and m.FAMILY == "lm":
            # big-LM posture: the residual stream sharded over 'model' too
            rules["act_btd"] = P(dp_axes(mesh), None, "model")
        if mesh is not None and m.FAMILY == "lm" and calibrate:
            # DTensor's propagation on a 2-D mesh costs ~1 ms an operator:
            # trace two depths (pairs for an alternating stack) with the
            # cell's microbatches and extrapolate every count, which grows
            # linearly with the depth, to the full stack
            L = m.full_config().n_layers
            cfg = m.full_config()
            layers = (2, 4) if cfg.has_local else (1, 2)
            a, b = (traced(mesh, lm_layers=n) for n in layers)
            main = _extrapolated(a, b, layers, L)
            calibrated = {"flops": float(main["flops"]),
                          "bytes_accessed": float(main["bytes_accessed"]),
                          "collective_bytes":
                              float(main["collectives"]["total_bytes"]),
                          "per_layer_flops": (b["flops"] - a["flops"])
                          / (layers[1] - layers[0])}
        else:
            main = traced(mesh)
    t_trace = time.time() - t0 - t_build

    single = None
    if calibrate and m.FAMILY in ("gnn", "recsys") and mesh_kind != "single":
        # the unsharded program: the "useful" flops, everything above it
        # is partitioning redundancy or padding
        with FakeTensorMode(allow_non_fake_inputs=True):
            step1, args1, _ = make_cell(arch, shape_name, None,
                                        attn_impl=model_attn,
                                        overrides=overrides)
            one = trace_step(step1, args1)
            del step1, args1
        single = {"flops": float(one["flops"]),
                  "bytes_accessed": float(one["bytes_accessed"]),
                  "collective_bytes": 0.0}

    rec.update(
        ok=True,
        lower_s=round(t_build, 2),
        compile_s=round(t_trace, 2),
        cost_calibrated=calibrated,
        calibrated_from_layers=layers,
        cost_single_device=single,
        memory={"argument_bytes": int(main["argument_bytes"]),
                "output_bytes": int(main["output_bytes"]),
                "temp_bytes": int(main["peak"] - main["argument_bytes"]),
                "peak_bytes": int(main["peak"]),
                "code_bytes": 0},
        cost={"flops": float(main["flops"]), "transcendentals": 0.0,
              "bytes_accessed": float(main["bytes_accessed"])},
        collectives=main["collectives"],
        replicated=main["replicated"],
        flops_by_op=main["flops_by_op"],
        custom_ops=main["custom_ops"],
        n_devices=n_dev,
        attn_impl=attn_impl,
        param_dtype=str(param_dtype).replace("torch.", ""),
    )
    if overrides:
        rec["overrides"] = overrides
    if verbose:
        mem = rec["memory"]
        print(f"[{arch} x {shape_name} x {mesh_kind}] build "
              f"{rec['lower_s']}s trace {rec['compile_s']}s")
        print(f"  memory/device: args {mem['argument_bytes'] / 2**30:.2f} "
              f"GiB, temp {mem['temp_bytes'] / 2**30:.2f} GiB, output "
              f"{mem['output_bytes'] / 2**30:.2f} GiB")
        print(f"  cost: flops {rec['cost']['flops']:.3e}, "
              f"bytes {rec['cost']['bytes_accessed']:.3e}")
        print("  collectives: " + ", ".join(
            f"{k}:{v['count']}({v['bytes'] / 2**20:.1f}MiB)"
            for k, v in rec["collectives"].items()
            if isinstance(v, dict) and v["count"]))
    return rec


def record_name(arch: str, shape: str, mesh_kind: str, tag: str = "",
                device: str = "cuda") -> str:
    """The file stem of a cell's record: ``arch__shape__mesh[__tag]``, and
    ``__cpu`` after a graph cell measured on the CPU, so that no CPU
    reading passes for the card's."""
    from ..configs import get_arch

    name = f"{arch.replace('/', '_')}__{shape}__{mesh_kind}"
    if tag:
        name += f"__{tag}"
    if get_arch(arch).FAMILY == "graph" and torch.device(device).type \
            == "cpu":
        name += "__cpu"
    return name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both", "single"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--attn-impl", default="ref", choices=["ref", "kernel"],
                    help="attention inside LM steps: 'ref' traces on CPU "
                         "fake tensors (the plain attention_ref), 'kernel' "
                         "on CUDA fake tensors (--mesh single, a CUDA "
                         "build): the card's path, kernel 10's forward and "
                         "backward operators")
    ap.add_argument("--out", default=None)
    ap.add_argument("--opt", default="",
                    help="comma list of optimization bundles: "
                         + ",".join(OPT_BUNDLES))
    ap.add_argument("--tag", default="",
                    help="suffix for output json (perf iterations)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the graph cells run: the card (default) "
                         "or cpu")
    args = ap.parse_args(argv)
    opts = tuple(o for o in args.opt.split(",") if o)
    unknown = set(opts) - set(OPT_BUNDLES)
    if unknown:
        ap.error(f"unknown --opt {sorted(unknown)}")

    from ..configs import all_cells

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a, s, _ in all_cells(include_skipped=True)]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")

    out_dir = Path(args.out) if args.out else OUT_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    failures = []
    for arch, shape in cells:
        for mk in meshes:
            tag = record_name(arch, shape, mk, args.tag, args.device)
            try:
                rec = run_cell(arch, shape, mk, attn_impl=args.attn_impl,
                               opts=opts, device=args.device)
            except Exception as e:
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape, "mesh": mk,
                       "ok": False, "error": f"{type(e).__name__}: {e}"}
                failures.append(tag)
            (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
    if failures:
        print("FAILED CELLS:", failures)
        sys.exit(1)
    print(f"all {len(cells) * len(meshes)} cells OK -> {out_dir}")


if __name__ == "__main__":
    main()
