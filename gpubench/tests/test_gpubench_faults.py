"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell of this kind can have (one chip: there is no
exchange between chips to leave out)."""
import importlib

import numpy as np
import pytest
import torch

from gpubench.tests._tiny import run_tiny, tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("faults"))


def unchanged_update(monkeypatch):
    """An update that returns the views as they were."""
    import repro_torch.stream.store as store

    def update_views(views, roles, ins, dels):
        none = lambda b: None if b is None else torch.zeros(  # noqa: E731
            b[0].shape[0], dtype=torch.bool)
        return views, none(ins), none(dels)
    monkeypatch.setattr(store, "update_views", update_views)


def stale_reads(monkeypatch):
    """A property read that returns its state without catching up."""
    from repro_torch.stream.properties import PropertyRegistry
    monkeypatch.setattr(PropertyRegistry, "read",
                        lambda self, name: self.peek(name)[0])


def half_batch(monkeypatch):
    """An update that applies the first half of its inserts and deletes."""
    from repro_torch.stream.store import GraphStore
    apply = GraphStore.apply

    def halved(self, ins_src=None, ins_dst=None, ins_w=None, del_src=None,
               del_dst=None):
        h = lambda a: a[:len(a) // 2]  # noqa: E731
        return apply(self, h(ins_src), h(ins_dst), ins_w, h(del_src),
                     h(del_dst))
    monkeypatch.setattr(GraphStore, "apply", halved)


def flipped_answer(monkeypatch):
    """A membership answer altered where the store produces it."""
    from repro_torch.stream.store import GraphStore
    query = GraphStore.query

    def flipped(self, src, dst):
        found = query(self, src, dst).copy()
        found[0] = ~found[0]
        return found
    monkeypatch.setattr(GraphStore, "query", flipped)


def nudged_pagerank(monkeypatch):
    """A PageRank vector altered where it is produced."""
    pr = importlib.import_module("repro_torch.algorithms.pagerank")
    pagerank = pr.pagerank

    def nudged(*args, **kw):
        vec, it = pagerank(*args, **kw)
        vec = vec.clone()
        vec[0] += 1e-3
        return vec, it
    monkeypatch.setattr(pr, "pagerank", nudged)


def relabelled_wcc(monkeypatch):
    """Component labels altered where they are produced."""
    wcc = importlib.import_module("repro_torch.algorithms.wcc")
    static = wcc.wcc_static

    def shifted(*args, **kw):
        labels = static(*args, **kw).clone()
        labels[-1] = labels.shape[0] - 1 if labels[-1] != labels.shape[0] - 1 \
            else 0
        return labels
    monkeypatch.setattr(wcc, "wcc_static", shifted)


@pytest.mark.parametrize("fault", [unchanged_update, stale_reads, half_batch,
                                   flipped_answer, nudged_pagerank,
                                   relabelled_wcc],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    result = run_tiny(root, seconds=0.6)
    assert result["correct"] is False
    failing = [n for n, row in result["checks"].items()
               if row["value"] > row["limit"]]
    assert failing


def test_sound_run_is_correct(root):
    result = run_tiny(root, seconds=0.6)
    assert result["correct"] is True, result["checks"]
    assert np.isfinite(result["checks"]["pagerank_l1"]["value"])
