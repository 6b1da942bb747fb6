"""Training: AdamW with global-norm clipping and warmup (``optimizer``) and
the host-driven loop with checkpoint/resume (``loop``), from
``repro.train``."""
from . import loop, optimizer
from .loop import Preempted, train
from .optimizer import AdamWConfig, AdamWState

__all__ = ["AdamWConfig", "AdamWState", "Preempted", "loop", "optimizer",
           "train"]
