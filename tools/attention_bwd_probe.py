#!/usr/bin/env python3
"""Probe kernel 10's backward on one CUDA card.

    python3 tools/attention_bwd_probe.py

Builds the attention sources with ``-Xptxas -v`` and prints each entry's
registers and spills, then on a sweep of shapes (the card test's
``ATTN_CASES`` kinds: GQA, windows, softcaps, ``kv_len``, Sq != Skv, head
dims 64, 128 and 256) in float32 and bfloat16: the forward with ``lse``
bit-equal to the forward without, ``lse`` against ``attention_lse_ref``,
the backward against ``attention_bwd_ref`` (float32 1e-4, bf16 2e-2 of
the scale), two backward launches bit-equal; then the forward (with and
without ``lse``) and the backward timed at gemma-2b's training shape (1 x
4,096 tokens, MQA 8/1, head_dim 256), five launches between CUDA events.
One JSON line a case; exits 1 when a case failed.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: (B, Hq, Hkv, Sq, Skv, D, causal, window, softcap, extra options)
CASES = [
    (1, 4, 4, 128, 128, 64, True, 0, 0.0, {}),
    (2, 4, 2, 256, 256, 64, True, 0, 0.0, {}),
    (1, 2, 2, 256, 256, 64, True, 64, 0.0, {}),
    (1, 2, 2, 128, 128, 64, True, 0, 30.0, {}),
    (1, 2, 2, 128, 128, 64, False, 0, 0.0, {}),
    (1, 2, 1, 128, 256, 128, True, 0, 0.0, {}),
    (1, 2, 2, 128, 256, 64, False, 0, 0.0, {"kv_len": 130}),
    (1, 2, 2, 256, 128, 64, True, 0, 0.0, {}),
    (1, 4, 2, 128, 128, 256, True, 64, 50.0, {}),
    (1, 2, 2, 128, 128, 64, True, 0, 0.0, {"kv_len": 0}),
    (1, 4, 2, 77, 77, 128, True, 40, 50.0, {}),
    (2, 4, 1, 300, 260, 64, True, 100, 0.0, {"kv_len": 250}),
    (1, 8, 1, 512, 512, 256, True, 0, 0.0, {}),
]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("attention_bwd_probe: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention import (
        attention_bwd_ref, attention_lse_ref, flash_attention_bwd_cuda,
        flash_attention_cuda)

    print(torch.__version__, torch.version.cuda, flush=True)
    built = runtime.build(("flash_attention", "flash_attention_bwd"),
                          verbose=True)
    for name, b in built.items():
        for ln in b["log"].splitlines():
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln:
                print(name, ln.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)

    def draw(shape, dt):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    bad = 0
    for i, (B, Hq, Hkv, Sq, Skv, D, causal, window, cap, extra) in \
            enumerate(CASES):
        for dt in (torch.float32, torch.bfloat16):
            q, do = draw((B, Hq, Sq, D), dt), draw((B, Hq, Sq, D), dt)
            k, v = draw((B, Hkv, Skv, D), dt), draw((B, Hkv, Skv, D), dt)
            kw = dict(causal=causal, window=window, softcap=cap,
                      sm_scale=D ** -0.5, kv_len=extra.get("kv_len", Skv))
            o, lse = flash_attention_cuda(q, k, v, lse=True, **kw)
            same = torch.equal(flash_attention_cuda(q, k, v, **kw), o)
            want_lse = attention_lse_ref(q, k, **kw)
            fin = torch.isfinite(want_lse)
            lse_err = float((lse[fin] - want_lse[fin]).abs().max()) \
                if fin.any() else 0.0
            inf_ok = torch.equal(torch.isinf(lse), ~fin)
            got = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
            again = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
            det = all(torch.equal(a, b) for a, b in zip(got, again))
            want = attention_bwd_ref(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            errs = [float((a.float() - b.float()).abs().max()) for a, b in
                    zip(got, want)]
            scale = [float(b.float().abs().max()) for b in want]
            tol = 2e-2 if dt == torch.bfloat16 else 1e-4
            ok = same and inf_ok and det and lse_err < 1e-4 and all(
                e <= tol * (1 + s) for e, s in zip(errs, scale))
            bad += not ok
            print(json.dumps({"case": i, "dtype": str(dt), "ok": ok,
                              "fwd_same": same, "lse_err": lse_err,
                              "lse_inf_ok": inf_ok, "det": det,
                              "errs": errs, "scale": scale}), flush=True)

    def events_ms(fn, n=5):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    for dt in (torch.bfloat16, torch.float32):
        S, D = 4096, 256
        q, do = draw((1, 8, S, D), dt), draw((1, 8, S, D), dt)
        k, v = draw((1, 1, S, D), dt), draw((1, 1, S, D), dt)
        kw = dict(causal=True, window=0, softcap=0.0, sm_scale=D ** -0.5,
                  kv_len=S)
        o, lse = flash_attention_cuda(q, k, v, lse=True, **kw)
        print(json.dumps({
            "gemma2b": str(dt),
            "fwd_ms": events_ms(lambda: flash_attention_cuda(q, k, v, **kw)),
            "fwd_lse_ms": events_ms(lambda: flash_attention_cuda(
                q, k, v, lse=True, **kw)),
            "bwd_ms": events_ms(lambda: flash_attention_bwd_cuda(
                q, k, v, o, lse, do, **kw))}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
