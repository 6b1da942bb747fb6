#!/usr/bin/env python3
"""Probe kernel 10's backward on one CUDA card.

    python3 tools/attention_bwd_probe.py [--no-cases] [--no-rounding]
                                         [--parent DIR ...]
                                         [--variant NAME ...]

Builds the attention sources with ``-Xptxas -v`` and prints each entry's
registers and spills, then on a sweep of shapes (the card test's
``ATTN_CASES`` kinds: GQA, windows, softcaps, ``kv_len``, Sq != Skv, head
dims 64, 128 and 256, and the work list's edges: MQA 8/1 at head_dim 256
over 1,000 tokens, Sq != Skv under a window) in float32 and bfloat16: the
forward with ``lse`` bit-equal to the forward without, ``lse`` against
``attention_lse_ref``, the backward against ``attention_bwd_ref`` within
``chip_smoke.BWD_TOL``, two backward launches bit-equal.  Then
``rounded_bwd`` (the plain backward with P and dS rounded once to bf16
before their products, as the tensor-core kernels feed them) against
``attention_bwd_ref`` within the bf16 ``BWD_TOL``, at gemma-2b's training
shape and on gemma2-9b's softcapped layers with q scaled by
``BWD_SOFTCAP_STRESS``.  Last, at gemma-2b's training shape (1 x 4,096
tokens, MQA 8/1, head_dim 256): the forward (with and without ``lse``)
and the backward, device-only (``chip_smoke.device_ms``), and the
backward's split by launch (``chip_smoke.bwd_split_ms``: delta, dK/dV,
its reduction, dQ).  ``--parent DIR`` (repeatable) also builds the
backward source of another checkout (an unpacked earlier commit whose C
entry point takes the same arguments) into ``build/attention_bwd_probe/``,
holds it to ``attention_bwd_ref`` on the 1,000-token MQA case, and times
it in turns with the committed one (committed, parents, parents,
committed) in both dtypes at gemma-2b's shape, on gemma2-9b's global and
local layer shapes (2 x 16 x 8,192 x 256, GQA 16/8, softcap 50) and on
qwen3-moe's layer 0 shape (2 x 32 x 8,192 x 128, GQA 32/4).
``--variant NAME`` (repeatable) does the same at gemma-2b's shape for the
committed source with a few lines edited (``VARIANTS``: most leave a part
of the work out, to show where the time goes; their answers are printed,
not checked).  One JSON line a case; exits 1 when a check failed.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "attention_bwd_probe"
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
    (1, 8, 1, 1000, 1000, 256, True, 0, 0.0, {}),
    (1, 4, 2, 700, 333, 128, True, 150, 0.0, {}),
    (1, 4, 2, 333, 700, 64, False, 90, 30.0, {"kv_len": 650}),
]
#: the timed shapes: (name, (B, Hq, Hkv, S, D), options, timed only with
#: parents and then for the committed build and the parents alone)
TIMED = [
    ("gemma-2b", (1, 8, 1, 4096, 256), {"window": 0, "softcap": 0.0},
     False),
    ("gemma2-9b global", (2, 16, 8, 8192, 256),
     {"window": 0, "softcap": 50.0}, True),
    ("gemma2-9b local", (2, 16, 8, 8192, 256),
     {"window": 4096, "softcap": 50.0}, True),
    ("qwen3-moe layer 0", (2, 32, 4, 8192, 128),
     {"window": 0, "softcap": 0.0}, True),
]
_ROUND_ONCE = [("      wgmma_rs(acc, al[j], mn_desc + ((j * 16 * 128) >> 4));\n",
                ""),
               ("      wgmma_rs(acc, al[j], kmn_desc + ((j * 16 * 128) >> 4));\n",
                "")]
#: name -> (what it changes, [(committed text, replacement), ...]) in
#: flash_attention_bwd.cu; each text must occur once
VARIANTS = {
    "round_once": ("bf16: P and dS rounded once (no lo products); outside "
                   "BWD_TOL on a few elements in 10^5", _ROUND_ONCE),
    "no_exp": ("bf16: P = x - lse, no expf (timing only)",
               [("expf(x - lse_r[c])", "(x - lse_r[c])"),
                ("expf(x - lr[r])", "(x - lr[r])")]),
    "no_dkdv_scores": (
        "bf16 dK/dV pass without its S^T and dP^T products (timing only)",
        [("    for (int kk = 0; kk < D / 16; ++kk)\n"
          "      wgmma_ss_n64(st, a_desc + kstep<kTcBK>(kk), "
          "b_desc + kstep<kTcBQ>(kk));\n", "")]),
    "no_dkdv_products": (
        "bf16 dK/dV pass without its dV and dK products (timing only)",
        [("      wgmma_rs(acc, ah[j], mn_desc + ((j * 16 * 128) >> 4));\n"
          "      wgmma_rs(acc, al[j], mn_desc + ((j * 16 * 128) >> 4));\n",
          "")]),
    "no_dq_scores": (
        "bf16 dQ pass without its S and dP products (timing only)",
        [("    for (int kk = 0; kk < D / 16; ++kk) {\n"
          "      if constexpr (kBKq == 32) {",
          "    for (int kk = 0; kk < 0; ++kk) {\n"
          "      if constexpr (kBKq == 32) {")]),
    "no_dq_products": (
        "bf16 dQ pass without its dQ products (timing only)",
        [("      wgmma_rs(acc, ah[j], kmn_desc + ((j * 16 * 128) >> 4));\n"
          "      wgmma_rs(acc, al[j], kmn_desc + ((j * 16 * 128) >> 4));\n",
          "")]),
}
#: rounded_bwd's shapes: (name, (B, Hq, Hkv, S, D), options, q scale)
ROUNDING = [
    ("gemma-2b", (1, 8, 1, 4096, 256), {"window": 0, "softcap": 0.0}, 1.0),
    ("gemma2-9b global, q x 8", (1, 2, 1, 8192, 256),
     {"window": 0, "softcap": 50.0}, 8.0),
    ("gemma2-9b local, q x 8", (1, 2, 1, 8192, 256),
     {"window": 4096, "softcap": 50.0}, 8.0),
]


def rounded_bwd(torch, q, k, v, o, lse, do, *, causal=True, window=0,
                softcap=0.0, sm_scale=None, kv_len=None):
    """``attention_bwd_ref``'s formulas with P and dS rounded once to bf16
    before their products (dV = P^T dO, dK = dS^T Q, dQ = dS K), the
    products and sums in float32: what the bf16 tensor-core kernels
    compute but for their summation order."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    sm_scale = D ** -0.5 if sm_scale is None else sm_scale
    kv_len = Skv if kv_len is None else kv_len
    with torch.no_grad():
        kk = k.float().repeat_interleave(g, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * sm_scale
        dcap = None
        if softcap > 0:
            t = torch.tanh(s / softcap)
            s, dcap = softcap * t, 1.0 - t * t
        qi = torch.arange(Sq, device=q.device)[:, None]
        kj = torch.arange(Skv, device=q.device)[None, :]
        mask = kj < kv_len
        if causal:
            mask = mask & (qi >= kj)
        if window > 0:
            mask = mask & (qi - kj < window)
        p = torch.exp(s - lse[..., None].float()).masked_fill(~mask, 0.0)
        del s
        dof = do.float()
        ds = torch.einsum("bhqd,bhkd->bhqk", dof,
                          v.float().repeat_interleave(g, dim=1))
        ds = p * (ds - (dof * o.float()).sum(-1)[..., None])
        if dcap is not None:
            ds = ds * dcap
        ds = (ds * sm_scale).bfloat16().float()
        p = p.bfloat16().float()
        fold = (B, Hkv, g, Skv, D)
        dv = torch.einsum("bhqk,bhqd->bhkd", p, dof).view(fold).sum(2)
        dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()).view(fold).sum(2)
        dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def variant_source(runtime, name: str) -> Path:
    """The committed backward source with ``VARIANTS[name]``'s edits, in
    its own directory beside a copy of its headers."""
    text = (runtime.CSRC / "flash_attention_bwd.cu").read_text()
    for old, new in VARIANTS[name][1]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} does not occur "
                               "once in the source")
        text = text.replace(old, new)
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for p in runtime._sources(runtime.CSRC / "flash_attention_bwd.cu")[1:]:
        (d / p.name).write_bytes(p.read_bytes())
    (d / "flash_attention_bwd.cu").write_text(text)
    return d / "flash_attention_bwd.cu"


def build_sources(runtime, sources: dict) -> dict:
    """{name: loaded library} of each backward source ({name: path}),
    compiled in parallel (its headers found beside it)."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        out = OUT / f"{name}.so"
        procs[name] = (subprocess.Popen(
            [runtime.nvcc(), *runtime.NVCC_FLAGS, "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--no-cases", action="store_true")
    ap.add_argument("--no-rounding", action="store_true")
    ap.add_argument("--parent", action="append", default=[])
    ap.add_argument("--variant", action="append", default=[],
                    choices=sorted(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_bwd_probe: no CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention import (
        attention_bwd_ref, attention_lse_ref, flash_attention_bwd_cuda,
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention import kernel as attn_kernel

    print(cs.gpu_line(), torch.__version__, torch.version.cuda, flush=True)
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
            enumerate([] if args.no_cases else CASES):
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
            tag = "bfloat16" if dt == torch.bfloat16 else "float32"
            r = cs.bwd_readings(torch, got, want, cs.BWD_TOL[tag])
            ok = same and inf_ok and det and lse_err < 1e-4 and r["close"]
            bad += not ok
            print(json.dumps({"case": i, "dtype": tag, "ok": ok,
                              "fwd_same": same, "lse_err": lse_err,
                              "lse_inf_ok": inf_ok, "det": det,
                              "bwd": r}), flush=True)

    for name, (B, Hq, Hkv, S, D), opt, scale in \
            [] if args.no_rounding else ROUNDING:
        dt = torch.bfloat16
        q, do = draw((B, Hq, S, D), dt) * scale, draw((B, Hq, S, D), dt)
        k, v = draw((B, Hkv, S, D), dt), draw((B, Hkv, S, D), dt)
        kw = dict(causal=True, sm_scale=D ** -0.5, kv_len=S, **opt)
        o, lse = flash_attention_cuda(q, k, v, lse=True, **kw)
        want = attention_bwd_ref(q, k, v, o, lse, do, **kw)
        r = cs.bwd_readings(torch, rounded_bwd(torch, q, k, v, o, lse, do,
                                               **kw), want,
                            cs.BWD_TOL["bfloat16"])
        print(json.dumps({"rounded_bwd": name, "q_scale": scale, **r}),
              flush=True)
        del q, do, k, v, o, lse, want
        torch.cuda.empty_cache()

    committed = attn_kernel._bwd_lib()
    libs = {"committed": committed}
    sources = {Path(d).resolve().name: Path(d).resolve() / "src" /
               "repro_torch" / "csrc" / "flash_attention_bwd.cu"
               for d in args.parent}
    sources.update({v: variant_source(runtime, v) for v in args.variant})
    for name, lib in build_sources(runtime, sources).items():
        lib.flash_attention_bwd.argtypes = \
            committed.flash_attention_bwd.argtypes
        lib.flash_attention_bwd.restype = committed.flash_attention_bwd.restype
        lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    real_lib = attn_kernel._bwd_lib

    def bwd_with(lib, *a, **kw):
        attn_kernel._bwd_lib = lambda: lib
        try:
            return flash_attention_bwd_cuda(*a, **kw)
        finally:
            attn_kernel._bwd_lib = real_lib

    if len(libs) > 1:      # each parent held to the plain version
        B, Hq, Hkv, Sq, Skv, D, causal, window, cap, extra = CASES[13]
        for dt in (torch.bfloat16, torch.float32):
            q, do = draw((B, Hq, Sq, D), dt), draw((B, Hq, Sq, D), dt)
            k, v = draw((B, Hkv, Skv, D), dt), draw((B, Hkv, Skv, D), dt)
            kw = dict(causal=causal, window=window, softcap=cap,
                      sm_scale=D ** -0.5, kv_len=Skv)
            o, lse = flash_attention_cuda(q, k, v, lse=True, **kw)
            want = attention_bwd_ref(q, k, v, o, lse, do, **kw)
            tag = "bfloat16" if dt == torch.bfloat16 else "float32"
            for name, lib in libs.items():
                r = cs.bwd_readings(torch, bwd_with(lib, q, k, v, o, lse, do,
                                                    **kw), want,
                                    cs.BWD_TOL[tag])
                if name not in VARIANTS:
                    bad += not r["close"]
                print(json.dumps({"build": name, "dtype": tag, **r}),
                      flush=True)

    for name, (B, Hq, Hkv, S, D), opt, wide in TIMED:
        names = [n for n in libs if not (wide and n in VARIANTS)]
        if wide and len(names) == 1:
            continue
        order = names + names[::-1]
        for tag in ("bfloat16", "float32"):
            dt = torch.bfloat16 if tag == "bfloat16" else torch.float32
            q, do = draw((B, Hq, S, D), dt), draw((B, Hq, S, D), dt)
            k, v = draw((B, Hkv, S, D), dt), draw((B, Hkv, S, D), dt)
            kw = dict(causal=True, sm_scale=D ** -0.5, kv_len=S, **opt)
            o, lse = flash_attention_cuda(q, k, v, lse=True, **kw)
            times = {n: [] for n in names}
            split = {}
            for n in order:
                def bwd(lib=libs[n]):
                    return bwd_with(lib, q, k, v, o, lse, do, **kw)
                times[n].append(cs.device_ms(
                    torch, bwd, samples=20 if name == "gemma-2b" else 3,
                    warmup=1))
                split.setdefault(n, cs.bwd_split_ms(torch, bwd, reps=2))
            line = {"timed": name, "dtype": tag, "bwd_ms": times,
                    "bwd_split_ms": split}
            if name == "gemma-2b":
                line["fwd_ms"] = cs.device_ms(
                    torch, lambda: flash_attention_cuda(q, k, v, **kw))
                line["fwd_lse_ms"] = cs.device_ms(
                    torch, lambda: flash_attention_cuda(q, k, v, lse=True,
                                                        **kw))
            print(json.dumps(line), flush=True)
            del q, do, k, v, o, lse
            torch.cuda.empty_cache()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
