"""Serving step builders for the LM family, from ``repro.launch.steps``.

``build_lm_prefill_step`` and ``build_lm_decode_step`` return the step a
server calls per request, over a ``TransformerLM``.  The train step, the
input and sharding specs and ``lm_cell`` wait for ``train/*`` and the
sharded plane (ROADMAP §1).
"""
from __future__ import annotations

from typing import Callable

from ..models.transformer import LMConfig, TransformerLM


def _check(model: TransformerLM, cfg: LMConfig) -> None:
    if model.cfg != cfg:
        raise ValueError(f"the step was built for {cfg.name}, the model is "
                         f"{model.cfg.name}")


def build_lm_prefill_step(cfg: LMConfig) -> Callable:
    """``prefill_step(model, tokens) -> (last logits (B, V), cache)``."""
    def prefill_step(model: TransformerLM, tokens):
        _check(model, cfg)
        return model.prefill(tokens)
    return prefill_step


def build_lm_decode_step(cfg: LMConfig) -> Callable:
    """``serve_step(model, cache, token, pos) -> (logits (B, V), cache)``;
    the cache is updated in place."""
    def serve_step(model: TransformerLM, cache, token, pos):
        _check(model, cfg)
        return model.decode_step(cache, token, pos)
    return serve_step
