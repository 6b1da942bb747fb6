"""Port parity: the sharding rules (``distributed/sharding.py``) and the
production meshes (``launch/mesh.py``) against ``repro.distributed
.sharding`` on the CPU.

* ``default_rules`` equals the reference's rule for rule, for a pod's and
  a multi-pod's axis names (the reference reads only ``mesh.axis_names``,
  so a stub mesh serves both).
* ``P`` converts to DTensor placements with JAX's major-to-minor order:
  ``P(("data", "model"))`` on dim 0 is ``[Shard(0), Shard(0)]``; axes out
  of the mesh's order, or used twice, raise.
* ``constrain`` returns its argument outside a rules context, for a name
  without a rule, and on a plain tensor; inside one, on a 2 x 2 mesh of a
  fake process group, a DTensor comes out with the rule's placements.
* ``sharding_rules`` restores the previous context on exit and on an
  exception.
* ``production_mesh`` builds the reference's 16 x 16 and 2 x 16 x 16
  shapes and axis names on a fake group of 256 or 512 ranks and leaves no
  default group behind; ``make_debug_mesh`` spans the running group.

Every fake process group here is created and destroyed inside a fixture
or a test, so no group outlives the test that made it.
"""
from types import SimpleNamespace

import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro.distributed import sharding as jsh
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed.sharding import P
from repro_torch.launch import mesh as tmesh

AXES = {"pod": ("data", "model"), "multipod": ("pod", "data", "model")}


def _entries(spec):
    """A spec's entries, one a tensor dim; a one-name tuple as the name
    (JAX's ``PartitionSpec`` normalises ``("data",)`` to ``"data"``)."""
    out = []
    for e in spec:
        if isinstance(e, (tuple, list)):
            e = e[0] if len(e) == 1 else tuple(e)
        out.append(e)
    return tuple(out)


@pytest.mark.parametrize("kind", sorted(AXES))
def test_default_rules_match_reference(kind):
    stub = SimpleNamespace(axis_names=AXES[kind])
    want = jsh.default_rules(stub)
    got = tsh.default_rules(stub)
    assert sorted(got) == sorted(want)
    for name, spec in want.items():
        assert isinstance(spec, JP)
        assert _entries(got[name]) == _entries(spec), name
    assert tsh.dp_axes(stub) == jsh.dp_axes(stub)


@pytest.fixture
def mesh22():
    """A 2 x 2 ("data", "model") mesh on a fake process group of 4 ranks,
    destroyed after the test."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield init_device_mesh("cpu", (2, 2),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_debug_mesh_spans_the_group(mesh22):
    mesh = tmesh.make_debug_mesh()
    assert tuple(mesh.mesh_dim_names) == ("data", "model")
    assert tuple(mesh.shape) == (4, 1)
    assert tuple(tmesh.make_debug_mesh(2).shape) == (2, 1)


def test_placements_follow_jax_order(mesh22):
    from torch.distributed.tensor import Replicate, Shard

    assert tsh.placements(mesh22, P(("data", "model"))) == [Shard(0),
                                                            Shard(0)]
    assert tsh.placements(mesh22, P(None, "model")) == [Replicate(),
                                                        Shard(1)]
    assert tsh.placements(mesh22, P()) == [Replicate(), Replicate()]
    assert tsh.placements(mesh22, P(("data",), None, "model")) == \
        [Shard(0), Shard(2)]
    with pytest.raises(ValueError, match="order"):
        tsh.placements(mesh22, P(("model", "data")))
    with pytest.raises(ValueError, match="twice"):
        tsh.placements(mesh22, P("data", "data"))
    with pytest.raises(ValueError, match="axis 'pod'"):
        tsh.placements(mesh22, P("pod"))


def test_constrain_is_identity_outside_a_context():
    x = torch.ones(4, 3)
    assert tsh.constrain(x, "act_btd") is x
    stub = SimpleNamespace(axis_names=AXES["pod"])
    with tsh.sharding_rules(stub):
        # a plain tensor, and a name without a rule
        assert tsh.constrain(x, "act_btd") is x
        assert tsh.constrain(x, "no_such_rule") is x
    assert tsh.spec_or_none("act_btd") is None


def test_constrain_applies_the_rules_placements(mesh22):
    from torch.distributed.tensor import distribute_tensor, Replicate

    rules = tsh.default_rules(mesh22)
    x = distribute_tensor(torch.randn(4, 6, 8), mesh22,
                          [Replicate(), Replicate()])
    nodes = distribute_tensor(torch.randn(8, 4, 3), mesh22,
                              [Replicate(), Replicate()])
    # outside a context: untouched
    assert tsh.constrain(x, "act_btd") is x
    with tsh.sharding_rules(mesh22):
        for name, t in (("act_btd", x), ("logits", x),
                        ("act_btd_tp", x), ("gnn_h_rows", nodes),
                        ("nodes", nodes)):
            got = tsh.constrain(t, name)
            assert list(got.placements) == tsh.placements(
                mesh22, rules[name]), name
            # (a fake group moves no data: the layout is what is held)
            assert got.shape == t.shape
        assert tsh.spec_or_none("logits") == rules["logits"]
    with tsh.sharding_rules(mesh22, {"act_btd": P(None, None, "model")}):
        got = tsh.constrain(x, "act_btd")
        assert list(got.placements) == tsh.placements(
            mesh22, P(None, None, "model"))


def test_sharding_rules_restores_the_previous_context():
    outer = SimpleNamespace(axis_names=AXES["pod"])
    inner = SimpleNamespace(axis_names=AXES["multipod"])
    with tsh.sharding_rules(outer) as r_outer:
        with tsh.sharding_rules(inner) as r_inner:
            assert tsh._CTX["mesh"] is inner
            assert tsh.spec_or_none("batch") == r_inner["batch"]
        assert tsh._CTX["mesh"] is outer
        assert tsh.spec_or_none("batch") == r_outer["batch"]
        with pytest.raises(RuntimeError, match="boom"):
            with tsh.sharding_rules(inner, {"batch": P(None)}):
                assert tsh.spec_or_none("batch") == P(None)
                raise RuntimeError("boom")
        assert tsh._CTX["mesh"] is outer
        assert tsh._CTX["rules"] is r_outer
    assert tsh._CTX == {"mesh": None, "rules": None}


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shapes(multi_pod):
    assert not dist.is_initialized()
    with tmesh.production_mesh(multi_pod=multi_pod) as mesh:
        kind = "multipod" if multi_pod else "pod"
        assert tuple(mesh.mesh_dim_names) == AXES[kind]
        assert tuple(mesh.shape) == ((2, 16, 16) if multi_pod else (16, 16))
        assert dist.get_world_size() == mesh.size()
    assert not dist.is_initialized()
    # a running group is refused, and left running
    with pytest.raises(RuntimeError, match="running already"):
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=2)
        try:
            with tmesh.production_mesh():
                pass
        finally:
            dist.destroy_process_group()
    assert not dist.is_initialized()
