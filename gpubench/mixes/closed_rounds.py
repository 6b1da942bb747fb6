"""Client of a mix that replays the serve's round back to back: one
client, closed loop.

A round is an update batch, the mix's property reads in order, and one
membership query, each through ``RequestPipeline.run``, one request at a
time; its freshness is the time from issuing the update to the return of
the last read.  The requests are drawn by ``harness.stream.EdgeStream``
from the run's seed, on the card, before the window: enough rounds for
``prepared_rounds_per_s`` over the window, so that the window holds the
program's work alone (a window that outruns them draws more as it goes,
and says so).  Everything given and answered goes into the session's
``RunLog`` for the check.  A mix that names this client and
asks for another number of clients or another loop is refused.

The end-to-end numbers of a window: ``fresh_p95_ms``, the nearest-rank
95th percentile of the freshness of the rounds that ended inside it, and
``fresh_edges_per_s``, the edges their updates requested over its
seconds.
"""
import math
import time

import numpy as np
import torch

from gpubench.harness import stats
from gpubench.harness.stream import EdgeStream


def open_client(session, mix: dict, seed: int):
    if int(mix["clients"]) != 1 or mix["loop"] != "closed":
        raise ValueError(f"mix {mix['name']!r}: closed_rounds drives one "
                         f"closed-loop client, not {mix['clients']} "
                         f"{mix['loop']}-loop")
    return Client(session, mix, seed)


class Client:
    def __init__(self, session, mix: dict, seed: int):
        from repro_torch.stream import PropertyRead
        self.s = session
        self.reads = [PropertyRead(n) for n in mix["reads"]]
        self.edges_per_round = int(mix["batch"])
        gen = torch.Generator(device=session.device)
        gen.manual_seed(int(seed))
        self.stream = EdgeStream(gen, session.graph, mix, session.initial,
                                 session.perm)
        self.warmup = int(mix["warmup_rounds"])
        self.rate = float(mix["prepared_rounds_per_s"])
        self.round_no = 0
        self.failed = 0
        self.drawn_in_window = 0

    def prepare(self, seconds: float) -> int:
        """Draw the warm-up's rounds and enough for ``seconds`` of window;
        the number of rounds ready."""
        return self.prepare_rounds(self.warmup
                                   + math.ceil(seconds * self.rate))

    def prepare_rounds(self, n: int) -> int:
        """Draw rounds until ``n`` are ready; ``n``."""
        self.stream.prepare(n - len(self.stream.ready))
        return n

    @property
    def requests_per_round(self) -> int:
        return 2 + len(self.reads)

    def draw(self):
        """The next round's update and membership query as the pipeline
        takes them, logged."""
        from repro_torch.stream import MembershipQuery, UpdateBatch
        V, log = self.s.V, self.s.runlog
        self.drawn_in_window += not self.stream.ready
        r = self.stream.next_round()
        log.rounds.append((r.deletes, r.inserts))

        def ends(keys):
            return ((keys // V).numpy().astype(np.uint32),
                    (keys % V).numpy().astype(np.uint32))
        (ds, dd), (is_, id_), (ms, md) = (ends(r.deletes), ends(r.inserts),
                                          ends(r.member))
        return (UpdateBatch(ins_src=is_, ins_dst=id_, del_src=ds,
                            del_dst=dd),
                MembershipQuery(src=ms, dst=md), r.member)

    def round(self, sample: bool = False):
        """Serve one round; (issued, fresh, ended) on the host clock."""
        update, member, member_keys = self.draw()
        run, log = self.s.pipeline.run, self.s.runlog
        t0 = time.perf_counter()
        up = run([update])[0]
        served = [run([rd])[0] for rd in self.reads]
        t1 = time.perf_counter()
        mem = run([member])[0]
        t2 = time.perf_counter()
        p = up.payload
        log.updates.append((p.get("inserted", -1), p.get("deleted", -1),
                            up.version if up.kind == "update" else -1))
        log.read_versions.append(
            [s.version if s.kind == "property" else -1 for s in served])
        found = (mem.payload["found"] if mem.kind == "member"
                 else np.zeros(len(member_keys), bool))
        log.member.append((member_keys,
                           torch.from_numpy(np.asarray(found, bool))))
        self.failed += sum(1 for x in [up, *served, mem] if x.kind == "error")
        if sample:
            log.samples[self.round_no] = {
                rd.name: self.s.host_value(s.payload["value"])
                for rd, s in zip(self.reads, served) if s.kind == "property"}
        self.round_no += 1
        return t0, t1, t2

    def window(self, seconds: float, sampled=frozenset(), after_round=None,
               clock=time.perf_counter):
        """Rounds back to back until ``seconds`` have passed; see
        ``run_window``."""
        return run_window(lambda i: self.round(self.round_no in sampled),
                          seconds, clock, after_round)


def run_window(round_fn, seconds: float, clock=time.perf_counter,
               after_round=None):
    """Closed loop: rounds back to back until ``seconds`` have passed.
    Returns the window's (start, end) and one (issued, fresh, ended) per
    round served, the last of which may end after the window.
    ``after_round(i, record, start)``, where given, runs after each round,
    outside its times."""
    start = clock()
    end = start + seconds
    rounds = []
    i = 0
    while clock() < end:
        rounds.append(round_fn(i))
        if after_round is not None:
            after_round(i, rounds[-1], start)
        i += 1
    return (start, end), rounds


def window_metrics(window, rounds, edges_per_round: int) -> dict:
    """``fresh_p95_ms`` over the rounds that ended inside the window,
    ``fresh_edges_per_s`` of their updates over the window's length, and
    ``rounds``, their number."""
    start, end = window
    done = [r for r in rounds if r[2] <= end]
    fresh = [1e3 * (r[1] - r[0]) for r in done]
    out = {"fresh_edges_per_s": stats.rate(len(done) * edges_per_round,
                                           end - start),
           "rounds": len(done)}
    if fresh:
        out["fresh_p95_ms"] = stats.percentile(fresh, 95)
    return out
