"""Port parity: the cell registry (``configs``) and the cell builders
(``launch/steps.py``) against ``repro.configs`` and
``repro.launch.steps`` on the CPU.

* ``ASSIGNED``, ``all_cells`` (with and without the skipped cells), the
  graph plane's config and ``MICROBATCH`` equal the reference's: 40
  assigned cells, 4 of them skipped.
* For every one of the 36 runnable cells at full config, on a pod's axis
  names (a stub mesh: the builders read only its axis names), the port's
  ``make_cell`` arguments have the reference's ``jax.eval_shape`` shapes
  and dtypes leaf for leaf (the arguments are fake tensors: nothing is
  allocated), and its spec trees equal the reference's
  ``lm_param_specs`` / ``lm_opt_specs`` / ``gnn_batch_shardings`` /
  ``mind_cell`` trees spec for spec.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.configs as jconfigs
from repro.launch import steps as jsteps
from repro.models.gnn.common import GraphBatch as JBatch
import repro_torch.configs as tconfigs
from repro_torch.distributed.sharding import P
from repro_torch.launch import steps as tsteps
from repro_torch.models.gnn.common import GraphBatch as TBatch

POD = SimpleNamespace(axis_names=("data", "model"))
RUNNABLE = [(a, s) for a, s, _ in jconfigs.all_cells()]

_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.int32: jnp.int32, torch.bool: jnp.bool_,
           torch.int64: jnp.int64}


def test_registry_matches_reference():
    assert tconfigs.ASSIGNED == jconfigs.ASSIGNED
    assert sorted(tconfigs.REGISTRY) == sorted(jconfigs.REGISTRY)
    for skipped in (False, True):
        assert tconfigs.all_cells(skipped) == jconfigs.all_cells(skipped)
    assert len(tconfigs.all_cells(True)) == 40
    assert len(tconfigs.all_cells()) == 36
    g, jg = tconfigs.get_arch("meerkat-graph"), \
        jconfigs.get_arch("meerkat-graph")
    assert (g.ARCH_ID, g.FAMILY, g.SHAPES, g.SKIP) == \
        (jg.ARCH_ID, jg.FAMILY, jg.SHAPES, jg.SKIP)
    assert g.full_config() == jg.full_config()
    assert g.smoke_config() == jg.smoke_config()
    assert tsteps.MICROBATCH == jsteps.MICROBATCH


def _port_leaves(tree):
    """Tensor leaves in JAX's flatten order (dicts by sorted key,
    NamedTuples and GraphBatches field by field, ``None`` empty)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _port_leaves(tree[k])]
    if isinstance(tree, TBatch):
        return [x for f in dataclasses.fields(tree) if f.name != "n_graphs"
                for x in _port_leaves(getattr(tree, f.name))]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _port_leaves(v)]
    return []


def _spec_leaves(tree):
    """Spec leaves in JAX's flatten order (a spec is a leaf)."""
    if tree is None or isinstance(tree, int):
        return []
    if isinstance(tree, (P, JP)):
        return [tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                      for e in tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, (TBatch, JBatch)):
        return [x for f in dataclasses.fields(tree) if f.name != "n_graphs"
                for x in _spec_leaves(getattr(tree, f.name))]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _spec_leaves(v)]
    raise TypeError(type(tree))


@pytest.mark.parametrize("arch,shape", RUNNABLE,
                         ids=[f"{a}-{s}" for a, s in RUNNABLE])
def test_cell_args_and_specs_match_reference(arch, shape):
    _, jargs, jspecs = jsteps.make_cell(arch, shape, POD)
    _, targs, tspecs = tsteps.make_cell(arch, shape, POD)
    want = jax.tree.leaves(jargs)
    got = _port_leaves(targs)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == tuple(w.shape), (i, g.shape, w.shape)
        assert _DTYPES[g.dtype] == w.dtype, (i, g.dtype, w.dtype)
    jleaves = [x for t in jspecs for x in _spec_leaves(t)]
    tleaves = [x for t in tspecs for x in _spec_leaves(t)]
    assert tleaves == jleaves
    # the GNN batch keeps its graph count
    for j, t in zip(jargs, targs):
        if isinstance(j, JBatch):
            assert t.n_graphs == j.n_graphs


def test_cell_builders_materialise_nothing():
    """The parameters come from the model's own ``init_params`` under
    ``FakeTensorMode``: qwen1.5-32b's 35.2e9 float32 parameters, AdamW's
    moments beside them, are fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensor

    _, args, _ = tsteps.make_cell("qwen1.5-32b", "train_4k", POD)
    leaves = _port_leaves(args)
    assert all(isinstance(t, FakeTensor) for t in leaves)
    n = sum(t.numel() for t in _port_leaves(args[0]))
    cfg = tconfigs.get_arch("qwen1.5-32b").full_config()
    # n_params() leaves out the QKV biases, as the reference's does
    biases = cfg.n_layers * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
    assert n == cfg.n_params() + biases
