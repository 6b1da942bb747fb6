"""Fault-tolerant training loop, from ``repro.train.loop``: step-granular
checkpoint/resume, simulated preemption, a straggler watchdog.

Host-driven, one step a call: the failure model is "any step may die", and
recovery is checkpoint-granular.  ``preempt_at`` injects a simulated
preemption (the tests' proof of resume equivalence).  The watchdog logs a
step far beyond the trailing median for a launcher's backup-worker policy.
Checkpoints are ``checkpoint.ckpt``'s, in the reference's format: a
``(params, opt_state)`` checkpoint of either package restores in the
other.  They restore onto the device of ``params``' first leaf.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, Optional

from ..checkpoint import ckpt
from ..core.tree import tree_leaves


class Preempted(RuntimeError):
    pass


def train(step_fn: Callable, params: Any, opt_state: Any,
          data_iter: Iterator, *, ckpt_dir, max_steps: int,
          ckpt_every: int = 50, resume: bool = True,
          preempt_at: Optional[int] = None,
          slow_step_factor: float = 3.0,
          log_every: int = 10, log: Callable = print) -> Dict:
    """Run ``step_fn(params, opt_state, *batch) -> (params, opt_state,
    loss)`` to ``max_steps`` with step-granular checkpoint/resume: resume
    from the newest checkpoint under ``ckpt_dir`` (and skip the data it
    consumed), checkpoint every ``ckpt_every`` steps and at the last."""
    ckpt_dir = Path(ckpt_dir)
    start_step = 0
    if resume:
        last = ckpt.latest_step(ckpt_dir)
        if last is not None:
            device = tree_leaves(params)[0].device
            (params, opt_state), extra = ckpt.restore(
                ckpt_dir, (params, opt_state), step=last, device=device)
            start_step = last
            # re-align the deterministic data stream with the restored step
            for _ in range(start_step):
                next(data_iter)
            log(f"[loop] resumed from step {last}")

    losses = []
    t_hist = []
    for step in range(start_step, max_steps):
        if preempt_at is not None and step == preempt_at:
            raise Preempted(f"simulated preemption at step {step}")
        batch = next(data_iter)
        t0 = time.time()
        params, opt_state, loss = step_fn(params, opt_state, *batch)
        loss = float(loss)
        dt = time.time() - t0
        losses.append(loss)
        # straggler watchdog: flag steps far beyond the trailing median
        if t_hist:
            med = sorted(t_hist)[len(t_hist) // 2]
            if dt > slow_step_factor * med:
                log(f"[loop][straggler] step {step} took {dt:.3f}s "
                    f"(median {med:.3f}s) - launcher may reassign")
        t_hist = (t_hist + [dt])[-50:]
        if (step + 1) % log_every == 0:
            log(f"[loop] step {step + 1}/{max_steps} loss {loss:.4f} "
                f"({dt * 1e3:.1f} ms)")
        if (step + 1) % ckpt_every == 0 or step + 1 == max_steps:
            ckpt.save(ckpt_dir, step + 1, (params, opt_state),
                      extra={"loss": loss})
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "final_step": max_steps}
