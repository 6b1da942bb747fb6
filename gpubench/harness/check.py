"""The comparison that decides ``correct``: what the timed path served,
against the plain reference replaying the same logged operations.

Numbers compared (each against its limit, ``limits/<cell>.json``):

* ``member_wrong``: membership answers of every round that differ from
  the edge set after that round's update;
* ``counts_wrong``: rounds whose update response gives other inserted or
  deleted counts than the edges that were absent or present;
* ``version_wrong``: rounds whose reads report another version than
  their update, or whose update does not advance the version;
* ``live_edges_gap``: the store's live edges at the end against the
  reference's;
* each property kind's own numbers, at the checked rounds
  (``gpubench/properties/<kind>.py``: ``NUMBERS`` and ``check``).
"""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from gpubench.reference.edges import EdgeLog, after_round


@dataclasses.dataclass
class RunLog:
    """Everything the timed path was given and answered, on the host."""
    n_vertices: int
    initial: torch.Tensor                                  # int64 keys
    rounds: List[Tuple[torch.Tensor, torch.Tensor]] = dataclasses.field(
        default_factory=list)                              # (deletes, inserts)
    member: List[Tuple[torch.Tensor, torch.Tensor]] = dataclasses.field(
        default_factory=list)                              # (keys, answers)
    updates: List[Tuple[int, int, int]] = dataclasses.field(
        default_factory=list)                         # inserted, deleted, v
    read_versions: List[List[int]] = dataclasses.field(default_factory=list)
    samples: Dict[int, Dict[str, object]] = dataclasses.field(
        default_factory=dict)                              # round -> values
    final_live: int = -1


def load_kind(root: Path, kind: str):
    """The property kind's file, ``gpubench/properties/<kind>.py``."""
    path = Path(root) / "gpubench" / "properties" / f"{kind}.py"
    if not path.is_file():
        raise ValueError(f"no property kind {kind!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"gpubench_kind_{kind}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def compare(log: RunLog, properties: List[dict], kinds: Dict[str, object],
            device) -> Dict[str, float]:
    """Every number compared, from the log and the reference on
    ``device``; ``kinds`` maps each property's kind to its file."""
    V = log.n_vertices
    edges = EdgeLog(V, log.initial.to(device),
                    [(d.to(device), i.to(device)) for d, i in log.rounds])
    out: Dict[str, float] = {}

    wrong = 0
    for r, (keys, answers) in enumerate(log.member):
        want = edges.member(keys.to(device), after_round(r))
        wrong += int((want.cpu() != answers.bool()).sum())
    out["member_wrong"] = wrong

    n_ins, n_del = edges.update_counts()
    n_ins, n_del = n_ins.tolist(), n_del.tolist()
    out["counts_wrong"] = sum(
        1 for r, (ins, dels, _v) in enumerate(log.updates)
        if ins != n_ins[r] or dels != n_del[r])

    bad, last = 0, None
    for (_i, _d, v), reads in zip(log.updates, log.read_versions):
        if (last is not None and v <= last) or any(x != v for x in reads):
            bad += 1
        last = v
    out["version_wrong"] = bad

    final = edges.edges_at(after_round(len(log.rounds) - 1))
    out["live_edges_gap"] = abs(log.final_live - final.numel())

    for p in properties:
        out.update(kinds[p["kind"]].NUMBERS)
    for r, served in sorted(log.samples.items()):
        keys = edges.edges_at(after_round(r))
        for p in properties:
            kinds[p["kind"]].check(p, keys, V, served[p["name"]], out)
    return out


def substitute_controls(log: RunLog, properties: List[dict],
                        kinds: Dict[str, object], device) -> List[str]:
    """Put each property kind's control (the reference one precision
    below the configuration's) in place of what the program served at
    every checked round; the names of the properties replaced."""
    V = log.n_vertices
    edges = EdgeLog(V, log.initial.to(device),
                    [(d.to(device), i.to(device)) for d, i in log.rounds])
    done = []
    for p in properties:
        control = getattr(kinds[p["kind"]], "control", None)
        if control is None:
            continue
        for r, served in log.samples.items():
            served[p["name"]] = control(p, edges.edges_at(after_round(r)),
                                        V).cpu()
        done.append(p["name"])
    return done


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """``correct`` and each number beside its limit; a number without a
    limit fails."""
    table = {name: {"value": value, "limit": limits.get(name)}
             for name, value in numbers.items()}
    ok = all(row["limit"] is not None and row["value"] <= row["limit"]
             for row in table.values())
    return ok, table
