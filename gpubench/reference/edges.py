"""Plain reference of a run's edge set, independent of the program.

It replays the run's logged edge operations (the initial edge list, then
per round its deletes and then its inserts, as the configurations state)
and answers what the timed path answered: the edge set at any round, and
so each membership answer, each update's inserted and deleted counts and
the live edge count.  Plain PyTorch on whichever device it is given; it
imports nothing of the program under test.

Edges are int64 keys ``src * V + dst``.  An operation's time is ``0`` for
the initial edges, ``2r + 1`` for round ``r``'s deletes and ``2r + 2`` for
its inserts, so "after round ``r``" is time ``2r + 2``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

INSERT = 1
DELETE = 0


def after_round(r: int) -> int:
    """The op-log time at which round ``r``'s update has applied."""
    return 2 * r + 2


class EdgeLog:
    """Every edge operation of a run, sorted by (key, time)."""

    def __init__(self, n_vertices: int, initial: torch.Tensor,
                 rounds: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
        self.V = int(n_vertices)
        dev = initial.device
        keys = [initial.long()]
        times = [torch.zeros(initial.numel(), dtype=torch.long, device=dev)]
        ops = [torch.full((initial.numel(),), INSERT, dtype=torch.int8,
                          device=dev)]
        for r, (dels, ins) in enumerate(rounds):
            for part, t, op in ((dels, 2 * r + 1, DELETE),
                                (ins, 2 * r + 2, INSERT)):
                part = part.to(dev).long()
                keys.append(part)
                times.append(torch.full((part.numel(),), t, dtype=torch.long,
                                        device=dev))
                ops.append(torch.full((part.numel(),), op, dtype=torch.int8,
                                      device=dev))
        self.n_rounds = len(rounds)
        self.tbits = max(1, (2 * self.n_rounds + 3).bit_length())
        if (self.V * self.V - 1).bit_length() + self.tbits > 63:
            raise ValueError("edge keys and times do not fit one int64")
        key = torch.cat(keys)
        time = torch.cat(times)
        comp = (key << self.tbits) | time
        # a stable sort keeps an op's order within one (key, time)
        comp, order = torch.sort(comp, stable=True)
        self.comp = comp
        self.key = key[order]
        self.time = time[order]
        self.op = torch.cat(ops)[order]

    def _last_op_at(self, keys: torch.Tensor, t: int) -> torch.Tensor:
        """For each key, the op that decides it at time ``t`` (``-1``:
        never touched, so absent)."""
        keys = keys.long().to(self.comp.device)
        probe = (keys << self.tbits) | t
        pos = torch.searchsorted(self.comp, probe, right=True) - 1
        pc = pos.clamp_min(0)
        hit = (pos >= 0) & (self.key[pc] == keys)
        return torch.where(hit, self.op[pc].long(), -1)

    def member(self, keys: torch.Tensor, t: int) -> torch.Tensor:
        """Whether each key is an edge at time ``t``."""
        return self._last_op_at(keys, t) == INSERT

    def edges_at(self, t: int) -> torch.Tensor:
        """The sorted keys of the edges present at time ``t``."""
        sel = self.time <= t
        k = self.key[sel]
        op = self.op[sel]
        last = torch.ones(k.numel(), dtype=torch.bool, device=k.device)
        if k.numel() > 1:
            last[:-1] = k[1:] != k[:-1]
        return k[last & (op == INSERT)]

    def update_counts(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per round, the inserts that added an absent edge and the deletes
        that removed a present one (each key counted once a phase)."""
        prev_same = torch.zeros(self.key.numel(), dtype=torch.bool,
                                device=self.key.device)
        prev_same[1:] = self.key[1:] == self.key[:-1]
        prev_op = torch.full_like(self.op, -1)
        prev_op[1:] = self.op[:-1]
        present_before = prev_same & (prev_op == INSERT)
        rnd = (self.time - 1) // 2
        phase_ins = (self.time > 0) & (self.op == INSERT)
        phase_del = (self.time > 0) & (self.op == DELETE)
        n = self.n_rounds
        ins = torch.bincount(rnd[phase_ins & ~present_before], minlength=n)
        dels = torch.bincount(rnd[phase_del & present_before], minlength=n)
        return ins[:n], dels[:n]


def split(keys: torch.Tensor, n_vertices: int):
    return keys // n_vertices, keys % n_vertices
