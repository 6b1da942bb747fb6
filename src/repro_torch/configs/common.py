"""The LM and recsys shape tables, from ``repro.configs.common``.

``kind`` selects the step: ``train`` (forward, backward and AdamW:
``launch.steps.build_lm_train_step`` and ``build_mind_train_step``),
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

RECSYS_SHAPES = {
    "train_batch": {"kind": "train", "batch": 65536},
    "serve_p99": {"kind": "serve", "batch": 512, "n_candidates": 4096},
    "serve_bulk": {"kind": "serve", "batch": 262144, "n_candidates": 4096},
    "retrieval_cand": {"kind": "retrieval", "batch": 1,
                       "n_candidates": 1000000},
}
