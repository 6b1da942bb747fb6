"""The LM, GNN and recsys shape tables, from ``repro.configs.common``.

``kind`` selects the step: ``train`` (forward, backward and AdamW:
``launch.steps.build_lm_train_step``, ``build_gnn_train_step`` and
``build_mind_train_step``; ``train_sampled`` on a fanout-sampled subgraph,
``train_batched`` on a batch of small graphs),
``prefill`` (logits and KV cache), ``decode`` (one new token against the
KV cache), ``serve`` (recsys candidate scoring) and ``retrieval`` (scoring
pre-materialised candidate embeddings).
"""
from __future__ import annotations

LM_SHAPES = {
    "train_4k": {"kind": "train", "seq_len": 4096, "global_batch": 256},
    "prefill_32k": {"kind": "prefill", "seq_len": 32768, "global_batch": 32},
    "decode_32k": {"kind": "decode", "seq_len": 32768, "global_batch": 128},
    "long_500k": {"kind": "decode", "seq_len": 524288, "global_batch": 1},
}

GNN_SHAPES = {
    "full_graph_sm": {"kind": "train", "n_nodes": 2708, "n_edges": 10556,
                      "d_feat": 1433},
    "minibatch_lg": {"kind": "train_sampled", "n_nodes": 232965,
                     "n_edges": 114615892, "batch_nodes": 1024,
                     "fanout": (15, 10)},
    "ogb_products": {"kind": "train", "n_nodes": 2449029,
                     "n_edges": 61859140, "d_feat": 100},
    "molecule": {"kind": "train_batched", "n_nodes": 30, "n_edges": 64,
                 "batch": 128},
}

RECSYS_SHAPES = {
    "train_batch": {"kind": "train", "batch": 65536},
    "serve_p99": {"kind": "serve", "batch": 512, "n_candidates": 4096},
    "serve_bulk": {"kind": "serve", "batch": 262144, "n_candidates": 4096},
    "retrieval_cand": {"kind": "retrieval", "batch": 1,
                       "n_candidates": 1000000},
}


def sampled_subgraph_size(shape: dict) -> tuple[int, int]:
    """(n_nodes, n_edges) of the fanout-sampled mini-batch subgraph."""
    b = shape["batch_nodes"]
    f1, f2 = shape["fanout"]
    n_nodes = b * (1 + f1 + f1 * f2)
    n_edges = b * (f1 + f1 * f2)
    return n_nodes, n_edges
