"""Port parity for checkpoints: the format both ways, the MessagePack codec,
and the crash-safety cases of the reference's ``TestCheckpointSafety``.

* A port ``GraphStore.save`` restores through the reference's
  ``GraphStore.restore`` (and the reverse), the three views leaf for leaf
  and the property states equal, on weighted and unweighted stores.  The
  triangle count is an int64 in the port and an int32 in the reference:
  each is widened or narrowed on restore, and compared by value.
* The port's MessagePack codec writes the bytes ``msgpack.packb`` writes
  and reads what it writes, on manifests and on generated nested values.
* Torn directories, missing leaves, a crash at each of the three
  ``ckpt.save.*`` sites, a same-step overwrite, a checkpoint of another
  layer and a missing spec, as the reference's tests hold them.

Everything is integer or compared as bytes: no tolerance.
"""
import random

import msgpack
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from _torch_port import assert_pools_equal, np_of

from repro import algorithms as jalg
from repro import stream as jstream
from repro.checkpoint import ckpt as jckpt
from repro_torch import algorithms as talg
from repro_torch import resilience as trz
from repro_torch import stream as tstream
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.checkpoint import msgpack_codec
from repro_torch.checkpoint.ckpt import CheckpointError
from repro_torch.resilience import faults

V = 64
CAP = 4096
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _disarm():
    faults.reset()
    yield
    faults.reset()


def _edges(weighted, seed=1, n=300):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, V, n).astype(np.uint32)
    dst = rng.integers(0, V, n).astype(np.uint32)
    w = rng.uniform(0.5, 3.0, n).astype(np.float32) if weighted else None
    return src, dst, w


def _churn(store, seed=2, epochs=2):
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        i = rng.integers(0, V, (30, 2)).astype(np.uint32)
        d = rng.integers(0, V, (8, 2)).astype(np.uint32)
        store.apply(i[:, 0], i[:, 1], None, d[:, 0], d[:, 1])


def _specs(pkg, weighted):
    """Every stream property of ``pkg`` for the store."""
    alg = talg if pkg == "torch" else jalg
    tree = (alg.sssp_stream_property(0, edge_capacity=CAP) if weighted else
            alg.bfs_stream_property(0, edge_capacity=CAP))
    return [alg.pagerank_stream_property(), tree, alg.wcc_stream_property(),
            alg.triangle_stream_property()]


def _state_arrays(state):
    """A property state as a list of numpy arrays (a tree state's planes)."""
    if hasattr(state, "parent"):
        return [np_of(state.dist), np_of(state.parent)]
    return [np_of(state)]


def _assert_states_equal(got, want, name):
    for a, b in zip(_state_arrays(got), _state_arrays(want)):
        if name == "triangles":
            assert int(a) == int(b), name
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), name


def _build(pkg, weighted):
    src, dst, w = _edges(weighted)
    mod = tstream if pkg == "torch" else jstream
    kw = {"device": "cpu"} if pkg == "torch" else {}
    store = mod.GraphStore.from_edges(V, src, dst, w, **kw)
    registry = mod.PropertyRegistry(store)
    for spec in _specs(pkg, weighted):
        registry.register(spec)
    _churn(store)
    for name in registry.names():
        registry.read(name)
    return store, registry


@pytest.mark.parametrize("weighted", [False, True])
def test_port_checkpoint_restores_in_reference(weighted, tmp_path):
    store, registry = _build("torch", weighted)
    store.save(tmp_path, registry=registry)
    jstore, jreg = jstream.GraphStore.restore(
        tmp_path, specs=_specs("jax", weighted))
    assert jstore.version == store.version
    assert jstore.weighted == weighted
    for name in ("forward", "transpose", "symmetric"):
        assert_pools_equal(store.views[name], jstore.views[name], name)
    assert jreg.versions() == registry.versions()
    for name in registry.names():
        _assert_states_equal(registry.peek(name)[0], jreg.peek(name)[0],
                             name)


@pytest.mark.parametrize("weighted", [False, True])
def test_reference_checkpoint_restores_in_port(weighted, tmp_path):
    jstore, jreg = _build("jax", weighted)
    jstore.save(tmp_path, registry=jreg)
    store, registry = tstream.GraphStore.restore(
        tmp_path, specs=_specs("torch", weighted), device="cpu")
    assert store.version == jstore.version
    assert store.device == CPU
    for name in ("forward", "transpose", "symmetric"):
        assert_pools_equal(store.views[name], jstore.views[name], name)
    assert registry.versions() == jreg.versions()
    for name in jreg.names():
        _assert_states_equal(registry.peek(name)[0], jreg.peek(name)[0],
                             name)
    # the widened triangle total, and a store that keeps serving alike
    assert registry.peek("triangles")[0].dtype == torch.int64
    ins = np.array([[3, 7], [7, 9], [9, 3]], np.uint32)
    store.apply(ins[:, 0], ins[:, 1])
    jstore.apply(ins[:, 0], ins[:, 1])
    for name in ("forward", "transpose", "symmetric"):
        assert_pools_equal(store.views[name], jstore.views[name], name)
    for name in jreg.names():
        if name.startswith("pagerank"):
            continue                  # float sums: held in the stream tests
        _assert_states_equal(registry.read(name), jreg.read(name), name)


def test_manifest_bytes_match_msgpack(tmp_path):
    store, registry = _build("torch", True)
    path = store.save(tmp_path, registry=registry)
    data = (path / "manifest.msgpack").read_bytes()
    assert msgpack.packb(msgpack.unpackb(data)) == data
    assert msgpack_codec.unpackb(data) == msgpack.unpackb(data)
    # the reference's manifest, read by the port's codec
    jstore, jreg = _build("jax", True)
    jpath = jstore.save(tmp_path / "ref", registry=jreg)
    jdata = (jpath / "manifest.msgpack").read_bytes()
    manifest = msgpack_codec.unpackb(jdata)
    assert manifest == msgpack.unpackb(jdata)
    assert msgpack_codec.packb(manifest) == jdata
    assert manifest["n_leaves"] == msgpack.unpackb(data)["n_leaves"]


def _nested(rng: random.Random, depth=0):
    """A nested value of the manifest's types at every encoding size."""
    kind = rng.randrange(10 if depth < 3 else 7)
    if kind == 0:
        return rng.choice([None, True, False])
    if kind in (1, 2):
        edge = rng.choice([0, 0x7F, 0x80, 0xFF, 0x100, 0xFFFF, 0x10000,
                           0xFFFFFFFF, 0x100000000, 2 ** 64 - 1, -1, -32,
                           -33, -128, -129, -32768, -32769, -2 ** 31,
                           -2 ** 31 - 1, -2 ** 63])
        return edge if kind == 1 else rng.randint(-2 ** 63, 2 ** 64 - 1)
    if kind == 3:
        return rng.choice([0.0, -1.5, 1e300, rng.uniform(-1e9, 1e9)])
    if kind in (4, 5, 6):
        n = rng.choice([0, 1, 31, 32, 255, 256, 65535, 65536])
        return "".join(rng.choice("abé中") for _ in range(n))
    if kind in (7, 8):
        return [_nested(rng, depth + 1)
                for _ in range(rng.choice([0, 1, 15, 16, 17]))]
    return {f"k{i}": _nested(rng, depth + 1)
            for i in range(rng.choice([0, 1, 15, 16, 20]))}


@given(st.integers(0, 2 ** 32 - 1))
@settings(max_examples=60, deadline=None)
def test_codec_matches_msgpack_on_nested_values(seed):
    value = _nested(random.Random(seed))
    want = msgpack.packb(value)
    assert msgpack_codec.packb(value) == want
    assert msgpack_codec.unpackb(want) == msgpack.unpackb(want)


def test_codec_rejects_malformed_bytes():
    for bad in (b"", b"\x92\x01", b"\x01\x02", b"\xc1", b"\xd9\x05ab"):
        with pytest.raises(msgpack_codec.MsgpackError):
            msgpack_codec.unpackb(bad)
    with pytest.raises(TypeError):
        msgpack_codec.packb({"x": object()})


def _store():
    src, dst, _ = _edges(False, seed=3, n=400)
    return tstream.GraphStore.from_edges(V, src, dst, device="cpu")


@pytest.mark.parametrize("site", ["ckpt.save.leaf", "ckpt.save.manifest",
                                  "ckpt.save.publish"])
def test_crash_mid_save_keeps_previous_checkpoint(site, tmp_path):
    store = _store()
    store.save(tmp_path)
    store.apply([1, 2], [3, 4], None, [], [])
    with pytest.raises(trz.InjectedCrash):
        with faults.inject(trz.FaultSpec(site, at=1)):
            store.save(tmp_path)
    assert tckpt.latest_step(tmp_path) == 0
    restored, _ = tstream.GraphStore.restore(tmp_path, device="cpu")
    assert restored.version == 0
    store.save(tmp_path)
    assert tckpt.latest_step(tmp_path) == store.version


def test_overwrite_same_step_is_crash_safe(tmp_path):
    store = _store()
    store.save(tmp_path, step=7)
    with pytest.raises(trz.InjectedCrash):
        with faults.inject(trz.FaultSpec("ckpt.save.publish", at=1)):
            store.save(tmp_path, step=7)
    assert tckpt.latest_step(tmp_path) == 7
    tckpt.validate_checkpoint(tmp_path / "step_0000000007")
    # the reference reads what survived
    assert jckpt.latest_step(tmp_path) == 7


def test_torn_dir_skipped_and_rejected(tmp_path):
    _store().save(tmp_path, step=1)
    torn = tmp_path / "step_0000000009"
    torn.mkdir()
    (torn / "manifest.msgpack").write_bytes(b"\x00garbage")
    assert tckpt.latest_step(tmp_path) == 1
    with pytest.raises(CheckpointError, match="corrupt"):
        tckpt.read_manifest(tmp_path, step=9)


def test_missing_leaf_rejected_with_actionable_error(tmp_path):
    path = _store().save(tmp_path, step=2)
    victim = sorted(path.glob("leaf_*.npy"))[0]
    victim.unlink()
    with pytest.raises(CheckpointError, match=victim.name):
        tckpt.read_manifest(tmp_path, step=2)
    assert tckpt.latest_step(tmp_path) is None


def test_non_stream_checkpoint_rejected_by_restore(tmp_path):
    tckpt.save(tmp_path, 0, {"x": np.zeros(3)}, extra={"other": True})
    with pytest.raises(CheckpointError, match="not a GraphStore"):
        tstream.GraphStore.restore(tmp_path, device="cpu")
    # the same tree written by the reference is byte-equal
    jckpt.save(tmp_path / "ref", 0, {"x": np.zeros(3)},
               extra={"other": True})
    for name in ("leaf_00000.npy",):
        assert (tmp_path / "step_0000000000" / name).read_bytes() == \
            (tmp_path / "ref" / "step_0000000000" / name).read_bytes()


def test_restore_requires_specs_for_saved_props(tmp_path):
    store = _store()
    registry = tstream.PropertyRegistry(store)
    registry.register(talg.wcc_stream_property())
    store.save(tmp_path, registry=registry)
    with pytest.raises(KeyError):
        tstream.GraphStore.restore(tmp_path, specs=(), device="cpu")


def test_restore_raises_for_cuda_without_a_card(tmp_path, monkeypatch):
    _store().save(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tstream.GraphStore.restore(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        trz.recover(tmp_path, tmp_path / "wal")


def test_bfloat16_leaf_round_trips_raw(tmp_path):
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4) \
        .to(torch.bfloat16) / 7
    path = tckpt.save(tmp_path, 0, {"w": x, "n": 3})
    info = msgpack.unpackb((path / "manifest.msgpack").read_bytes())
    assert info["leaves"][1] == {"i": 1, "shape": [3, 4],
                                 "dtype": "bfloat16", "raw": True}
    tree, _ = tckpt.restore(tmp_path, {"w": torch.bfloat16, "n": 0},
                            device="cpu")
    assert tree["w"].dtype == torch.bfloat16 and torch.equal(tree["w"], x)
    assert int(tree["n"]) == 3
    jtree, _ = jckpt.restore(tmp_path, {"w": np.zeros((3, 4)), "n": 0})
    assert np.array_equal(np.asarray(jtree["w"], np.float32),
                          x.float().numpy())


def test_serve_checkpoint_flag_restores_in_both_packages(tmp_path):
    from repro_torch.launch import serve
    ck = tmp_path / "ck"
    out = serve.main(["--device", "cpu", "--vertices", "256",
                      "--initial-edges", "2000", "--requests", "6",
                      "--batch", "64", "--tombstone-ratio", "0.01",
                      "--checkpoint", str(ck), "--metrics-json",
                      str(tmp_path / "m.json")])
    store, registry = out["store"], out["registry"]
    assert (tmp_path / "m.json").exists()
    specs = {"torch": [talg.pagerank_stream_property(),
                       talg.bfs_stream_property(0, edge_capacity=CAP),
                       talg.wcc_stream_property()],
             "jax": [jalg.pagerank_stream_property(),
                     jalg.bfs_stream_property(0, edge_capacity=CAP),
                     jalg.wcc_stream_property()]}
    got, greg = tstream.GraphStore.restore(ck, specs=specs["torch"],
                                           device="cpu")
    jgot, jreg = jstream.GraphStore.restore(ck, specs=specs["jax"])
    assert got.version == jgot.version == store.version
    assert got._resilience_meta() == jgot._resilience_meta() == \
        store._resilience_meta()
    for name in ("forward", "transpose"):
        assert_pools_equal(got.views[name], jgot.views[name], name)
        assert_pools_equal(store.views[name], jgot.views[name], name)
    assert greg.versions() == jreg.versions() == registry.versions()
    assert greg.status() == {n: {"policy": "lazy", "version": v,
                                 "stale": v < got.version}
                             for n, v in registry.versions().items()}
    for name in registry.names():
        state, version = greg.peek(name)
        _assert_states_equal(state, registry.peek(name)[0], name)
        _assert_states_equal(state, jreg.peek(name)[0], name)
    # a forced static recompute re-anchors the version
    greg.refresh("wcc")
    assert greg.versions()["wcc"] == got.version
    assert torch.equal(greg.peek("wcc")[0], registry.read("wcc"))
