"""The requests of a round, drawn before the window at O(batch) cost.

A round of a mix is one update batch (inserts drawn from the
configuration's generator, deletes drawn uniformly without replacement
from the edges the stream has put in), the property reads, and one
membership query (a share of its pairs drawn from those edges, the rest
uniform, so that its answers hold hits and misses alike).  On a symmetric
configuration every edge drawn is inserted or deleted in both directions,
so a batch of ``batch`` directed edges draws ``batch / 2`` edges.

``prepare`` draws many rounds at once: the random numbers of all of them
in a few calls on the generator's device, then each round's bookkeeping
in turn on the host.  The pool of edges put in is a multiset in a host
array (one entry an edge, ``min * V + max`` on a symmetric
configuration): the initial list, then every insert; a delete draw
removes its copy by moving tail entries into the holes, so no draw scans
the edge set.  Nothing of it stays on the card, so the card's memory peak
is the program's.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Optional

import torch

from . import graphs


@dataclasses.dataclass
class Round:
    """One round's directed edges as int64 keys ``src * V + dst`` (host)."""
    deletes: torch.Tensor
    inserts: torch.Tensor
    member: torch.Tensor


def distinct_draws(gen: torch.Generator, n: int, k: int) -> torch.Tensor:
    """``k`` distinct indices of ``[0, n)``, uniform: the first ``k``
    distinct values of a stream of uniform draws, in draw order."""
    if k > n:
        raise ValueError(f"cannot draw {k} distinct of {n}")
    m = k + k // 8 + 64
    while True:
        idx = torch.randint(0, n, (m,), generator=gen, device=gen.device)
        s, order = torch.sort(idx, stable=True)
        first = torch.ones(m, dtype=torch.bool, device=idx.device)
        first[1:] = s[1:] != s[:-1]
        pos = torch.sort(order[first]).values
        if pos.numel() >= k:
            return idx[pos[:k]]
        m *= 2


class EdgeStream:
    """Draws the rounds of a mix from ``gen`` (on any device).  ``initial``
    (int64 keys, both directions on a symmetric configuration) seeds the
    pool of edges put in; ``perm`` relabels every draw as it relabelled
    the initial list."""

    def __init__(self, gen: torch.Generator, graph: dict, mix: dict,
                 initial: torch.Tensor, perm: Optional[torch.Tensor]):
        self.gen = gen
        self.graph = graph
        self.V = 1 << int(graph["scale"])
        self.sym = bool(graph["symmetric"])
        self.perm = None if perm is None else perm.cpu()
        per = 2 if self.sym else 1
        batch = int(mix["batch"])
        n_del = int(round(batch * float(mix["delete_share"])))
        if n_del % per or (batch - n_del) % per:
            raise ValueError("a symmetric stream draws whole edge pairs")
        self.n_del, self.n_ins = n_del // per, (batch - n_del) // per
        self.n_member = int(mix["member_pairs"])
        self.n_member_pool = int(round(self.n_member *
                                       float(mix["member_from_pool_share"])))
        initial = initial.cpu()
        if self.sym:
            initial = initial[initial // self.V < initial % self.V]
        n = initial.numel()
        self.pool = torch.empty(n + self.n_ins + 1, dtype=torch.long)
        self.pool[:n] = initial
        self.n = n
        self.ready: Deque[Round] = collections.deque()

    def _grow(self, need: int) -> None:
        if need > self.pool.numel():
            bigger = torch.empty(max(need, self.pool.numel() * 3 // 2),
                                 dtype=torch.long)
            bigger[:self.n] = self.pool[:self.n]
            self.pool = bigger

    def _remove(self, holes: torch.Tensor) -> None:
        """Drop the pool entries at ``holes`` (distinct) by moving the tail
        entries that are not holes into the holes below the tail."""
        k = holes.numel()
        tail = self.n - k
        in_tail = torch.zeros(k, dtype=torch.bool)
        in_tail[holes[holes >= tail] - tail] = True
        movers = tail + torch.nonzero(~in_tail).flatten()
        low = holes[holes < tail]
        self.pool[low] = self.pool[movers]
        self.n = tail

    def _both(self, keys: torch.Tensor) -> torch.Tensor:
        if not self.sym:
            return keys
        return torch.cat([keys, graphs.reverse(keys, self.V)])

    def _holes(self, sizes: torch.Tensor) -> torch.Tensor:
        """Per round ``r``, ``n_del`` distinct indices of ``[0, sizes[r])``,
        uniform: the first distinct values of a row of uniform draws, in
        draw order."""
        g, k = self.gen, self.n_del
        R, m = sizes.numel(), k + k // 8 + 64
        u = torch.rand(R, m, generator=g, device=g.device,
                       dtype=torch.float64)
        idx = (u * sizes.to(g.device, torch.float64)[:, None]).long()
        s, order = torch.sort(idx, dim=1, stable=True)
        first = torch.ones_like(idx, dtype=torch.bool)
        first[:, 1:] = s[:, 1:] != s[:, :-1]
        keep = torch.zeros_like(first).scatter_(1, order, first)
        keep &= torch.cumsum(keep, 1) <= k
        out = torch.empty(R, k, dtype=torch.long, device=g.device)
        short = keep.sum(1) < k
        out[~short] = idx[keep & ~short[:, None]].view(-1, k)
        for r in torch.nonzero(short).flatten().tolist():
            out[r] = distinct_draws(g, int(sizes[r]), k)
        return out.cpu()

    def prepare(self, n_rounds: int) -> None:
        """Draw ``n_rounds`` more rounds."""
        g, V, R = self.gen, self.V, int(n_rounds)
        if R <= 0:
            return
        if self.n < self.n_del:
            raise ValueError("the stream holds fewer edges than a batch "
                             "deletes")
        step = self.n_ins - self.n_del
        sizes = self.n + step * torch.arange(R)
        holes = self._holes(sizes)
        inserts = graphs.relabel(
            graphs.draw_exactly(g, self.graph, R * self.n_ins).cpu(),
            self.perm, V).view(R, self.n_ins)
        if self.sym:
            inserts = graphs.canonical(inserts, V)
        picks = (torch.rand(R, self.n_member_pool, generator=g,
                            device=g.device, dtype=torch.float64)
                 * (sizes + step).to(g.device, torch.float64)[:, None]
                 ).long().cpu()
        turn = (torch.rand(R, self.n_member_pool, generator=g,
                           device=g.device) < 0.5).cpu()
        uniform = graphs.uniform(g, R * (self.n_member - self.n_member_pool),
                                 int(self.graph["scale"])).cpu().view(R, -1)
        for r in range(R):
            deletes = self.pool[holes[r]].clone()
            self._remove(holes[r])
            self._grow(self.n + self.n_ins)
            self.pool[self.n:self.n + self.n_ins] = inserts[r]
            self.n += self.n_ins
            from_pool = self.pool[picks[r]]
            if self.sym:
                from_pool = torch.where(turn[r], graphs.reverse(from_pool, V),
                                        from_pool)
            self.ready.append(Round(self._both(deletes),
                                    self._both(inserts[r]),
                                    torch.cat([from_pool, uniform[r]])))

    def next_round(self) -> Round:
        if not self.ready:
            self.prepare(1)
        return self.ready.popleft()
