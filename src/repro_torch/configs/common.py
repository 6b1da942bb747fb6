"""The LM shape table, from ``repro.configs.common.LM_SHAPES``.

``kind`` selects the step: ``train`` (not ported), ``prefill`` (logits and
KV cache) and ``decode`` (one new token against the KV cache).
"""
from __future__ import annotations

LM_SHAPES = {
    "train_4k": {"kind": "train", "seq_len": 4096, "global_batch": 256},
    "prefill_32k": {"kind": "prefill", "seq_len": 32768, "global_batch": 32},
    "decode_32k": {"kind": "decode", "seq_len": 32768, "global_batch": 128},
    "long_500k": {"kind": "decode", "seq_len": 524288, "global_batch": 1},
}
