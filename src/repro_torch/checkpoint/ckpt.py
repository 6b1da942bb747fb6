"""Crash-safe checkpoints: one ``.npy`` file a leaf plus a MessagePack
manifest, in the reference's format.

* step-granular atomic checkpoints (write into a hidden tmp dir, fsync,
  rename), with the previous copy of a step moved aside first and removed
  only once the new one is in place,
* bounded retention (``keep_last``) and crash-safe resume discovery:
  ``latest_step`` skips a torn directory,
* plain numpy and a bundled MessagePack codec (``msgpack_codec``).

**Format.**  ``step_<10 digits>/leaf_<5 digits>.npy`` and
``manifest.msgpack`` with the keys ``step``, ``treedef``, ``n_leaves``,
``time``, ``extra`` and ``leaves`` (one ``{i, shape, dtype, raw}`` each).
Leaves are numbered in JAX's flatten order (``core.tree``), so either
package reads the other's checkpoints: dict keys sorted, a
``SlabGraph``'s tensors in ``FIELDS`` order with ``None`` (an unweighted
graph's ``weights``) skipped, tuples (``TreeState``) and lists in order,
and anything else a leaf.  Keys, which the port keeps as int32 bit
patterns, are written as uint32 (the reference's dtype, the same bytes); a
bfloat16 leaf is written ``raw`` as uint16 with ``dtype: "bfloat16"``.
``treedef`` describes the structure for a reader; ``restore`` checks only
``n_leaves``.
"""
from __future__ import annotations

import os
import shutil
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.slab_graph import FIELDS, SlabGraph
from ..core.tree import flatten
from ..resilience import faults
from . import msgpack_codec


class CheckpointError(RuntimeError):
    """A checkpoint is missing, partial or corrupt.  ``latest_step`` never
    selects one that would raise this, so it usually means an explicit
    ``step=`` pointed at a torn directory."""


_REQUIRED_MANIFEST_KEYS = ("step", "treedef", "n_leaves", "extra", "leaves")


def _describe(tree) -> str:
    """The structure of ``tree`` with ``*`` for each leaf (the manifest's
    ``treedef``)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, SlabGraph):
        return (f"SlabGraph[{tree.n_vertices}, {tree.n_buckets}, "
                f"{tree.weighted}](" + ", ".join(
                    _describe(getattr(tree, f)) for f in FIELDS) + ")")
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__ + "(" +
                ", ".join(_describe(x) for x in tree) + ")")
    return "*"


def _host_leaf(path: str, leaf) -> Tuple[np.ndarray, str, bool]:
    """(array to write, logical dtype name, raw) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:       # numpy has no bfloat16
            return (t.view(torch.int16).cpu().numpy().view(np.uint16),
                    "bfloat16", True)
        arr = t.cpu().numpy()
    else:
        arr = np.asarray(leaf)
    if path.endswith("/keys") and arr.dtype == np.int32:
        arr = arr.view(np.uint32)           # the int32 bit patterns of keys
    return arr, str(arr.dtype), False


def _fsync_dir(path: Path) -> None:
    """Durably record a directory's entries (the rename itself)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:                      # no directory open: best effort
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


# ----------------------------------------------------------------------------
# validation, save, discovery, restore
# ----------------------------------------------------------------------------

def validate_checkpoint(path) -> Dict:
    """Structurally validate one ``step_*`` dir; return its manifest.

    The manifest exists, unpacks and carries the required keys, and every
    leaf file it lists is present and non-empty; else
    :class:`CheckpointError` names the first problem found."""
    path = Path(path)
    mf = path / "manifest.msgpack"
    if not mf.exists():
        raise CheckpointError(
            f"{path} has no manifest.msgpack - the save was interrupted "
            "before publish; delete the directory or pick another step")
    try:
        manifest = msgpack_codec.unpackb(mf.read_bytes())
    except Exception as e:
        raise CheckpointError(
            f"{path}/manifest.msgpack is corrupt ({type(e).__name__}: {e}) "
            "- pick another step or re-checkpoint") from e
    if not isinstance(manifest, dict):
        raise CheckpointError(
            f"{path}/manifest.msgpack is corrupt (not a map) - pick "
            "another step or re-checkpoint")
    missing = [k for k in _REQUIRED_MANIFEST_KEYS if k not in manifest]
    if missing:
        raise CheckpointError(
            f"{path}/manifest.msgpack is missing keys {missing} - saved by "
            "an incompatible version; pick another step")
    if len(manifest["leaves"]) != manifest["n_leaves"]:
        raise CheckpointError(
            f"{path} manifest lists {len(manifest['leaves'])} leaves but "
            f"declares n_leaves={manifest['n_leaves']} - corrupt manifest")
    for info in manifest["leaves"]:
        leaf = path / f"leaf_{info['i']:05d}.npy"
        if not leaf.exists() or leaf.stat().st_size == 0:
            raise CheckpointError(
                f"{path} is partial: {leaf.name} is "
                f"{'missing' if not leaf.exists() else 'empty'} - the save "
                "was interrupted; pick another step or re-checkpoint")
    return manifest


def _gc_stale(ckpt_dir: Path) -> None:
    """Sweep the work dirs a crashed saver left behind."""
    for junk in list(ckpt_dir.glob(".tmp_step_*")) + \
            list(ckpt_dir.glob(".old_step_*")):
        shutil.rmtree(junk, ignore_errors=True)


def save(ckpt_dir, step: int, tree: Any, *, extra: Optional[Dict] = None,
         keep_last: int = 3) -> Path:
    """Atomically persist ``tree`` for ``step``; returns the final path.

    Leaves and manifest are written and fsynced into a hidden tmp dir, then
    published by rename; a previous copy of the same step is moved aside
    first and removed only after the new one is in place, so a kill at any
    point leaves at least one restorable copy."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:010d}"
    tmp = ckpt_dir / f".tmp_step_{step:010d}_{os.getpid()}"
    old = ckpt_dir / f".old_step_{step:010d}_{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    leaves, _ = flatten(tree)
    manifest = {
        "step": int(step),
        "treedef": _describe(tree),
        "n_leaves": len(leaves),
        "time": time.time(),
        "extra": extra or {},
        "leaves": [],
    }
    for i, (path, leaf) in enumerate(leaves):
        faults.fault_point("ckpt.save.leaf", step=int(step), i=i)
        arr, dtype, raw = _host_leaf(path, leaf)
        with open(tmp / f"leaf_{i:05d}.npy", "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"].append({"i": i, "shape": list(arr.shape),
                                   "dtype": dtype, "raw": raw})
    faults.fault_point("ckpt.save.manifest", step=int(step))
    with open(tmp / "manifest.msgpack", "wb") as f:
        f.write(msgpack_codec.packb(manifest))
        f.flush()
        os.fsync(f.fileno())

    faults.fault_point("ckpt.save.publish", step=int(step))
    if final.exists():
        if old.exists():
            shutil.rmtree(old)
        os.rename(final, old)
    os.rename(tmp, final)
    _fsync_dir(ckpt_dir)
    shutil.rmtree(old, ignore_errors=True)

    steps = sorted(p for p in ckpt_dir.glob("step_*") if p.is_dir())
    for stale in steps[:-keep_last]:
        shutil.rmtree(stale, ignore_errors=True)
    _gc_stale(ckpt_dir)
    return final


def latest_step(ckpt_dir) -> Optional[int]:
    """Newest step whose checkpoint is structurally complete (torn dirs
    are skipped)."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    for p in reversed(sorted(ckpt_dir.glob("step_*"))):
        try:
            validate_checkpoint(p)
        except CheckpointError:
            continue
        return int(p.name.split("_")[1])
    return None


def read_manifest(ckpt_dir, *, step: Optional[int] = None) -> Dict:
    """A checkpoint's validated manifest, without reading its leaves (the
    GraphStore reads its structure from ``extra`` before ``restore``)."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return validate_checkpoint(ckpt_dir / f"step_{step:010d}")


def _leaf_dtype(like) -> Optional[torch.dtype]:
    """The torch dtype a restored leaf takes from its skeleton leaf: a
    tensor's, a ``torch.dtype`` placeholder, or None (keep the file's)."""
    if isinstance(like, torch.dtype):
        return like
    if isinstance(like, torch.Tensor):
        return like.dtype
    return None


def restore(ckpt_dir, like: Any, *, step: Optional[int] = None,
            device="cuda") -> Tuple[Any, Dict]:
    """Restore into the structure of ``like`` on ``device`` (``cuda``
    unless the caller passes ``"cpu"``); returns ``(tree, extra)``.

    A skeleton leaf may be a tensor or a ``torch.dtype``: the restored
    leaf takes its dtype (int32 keys from the file's uint32 bits, a
    narrower integer widened).  Any other skeleton leaf keeps the file's
    dtype.  Each leaf is read and moved to the device on its own, so the
    host holds one leaf at a time."""
    dev = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = ckpt_dir / f"step_{step:010d}"
    manifest = validate_checkpoint(path)

    leaves_like, rebuild = flatten(like)
    if manifest["n_leaves"] != len(leaves_like):
        raise CheckpointError(
            f"{path} holds {manifest['n_leaves']} leaves but the restore "
            f"skeleton has {len(leaves_like)} - the ``like`` structure does "
            "not match what was saved (wrong store kind, missing property "
            "specs, or a different view set)")
    out = []
    for i, (leaf_path, ref) in enumerate(leaves_like):
        try:
            # (C order, as np.save writes it; np.require keeps 0-d shapes)
            arr = np.require(np.load(path / f"leaf_{i:05d}.npy"),
                             requirements="C")
        except Exception as e:
            raise CheckpointError(
                f"{path}/leaf_{i:05d}.npy failed to load "
                f"({type(e).__name__}: {e}) - the checkpoint is corrupt; "
                "pick another step or re-checkpoint") from e
        info = manifest["leaves"][i]
        want = _leaf_dtype(ref)
        if info.get("raw"):
            if info["dtype"] != "bfloat16":
                raise CheckpointError(f"{path}: leaf {i} has raw dtype "
                                      f"{info['dtype']!r}; the port reads "
                                      "raw bfloat16 leaves only")
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            if arr.dtype == np.uint32 and (want in (None, torch.int32)):
                arr = arr.view(np.int32)     # keys: the int32 bit patterns
            t = torch.from_numpy(arr)
        if want is not None and t.dtype != want:
            t = t.to(want)
        out.append(t.to(dev))
    return rebuild(iter(out)), manifest["extra"]
