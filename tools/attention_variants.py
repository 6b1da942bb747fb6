#!/usr/bin/env python3
"""Build variants of the flash-attention source and hold each beside the
committed kernel on one CUDA card.

    python3 tools/attention_variants.py [variant ...]

Each variant is the committed ``src/repro_torch/csrc/flash_attention.cu``
with a few lines edited (``VARIANTS``).  All are compiled in parallel with
``ptxas -v`` into ``build/attention_variants/`` and loaded with ctypes (the
C entry point is the committed one's).  For each, the script prints:

* the registers, spill bytes and tensor-core instruction count of every
  bf16 instantiation (``chip_smoke.attention_build_readings``);
* which bf16 cases of the card test (``ATTN_CASES`` and the gemma2 case of
  ``tests/test_torch_gpu.py``) fall outside the test's 2e-2 of
  ``attention_ref``;
* its device time on gemma2-9b's layer shapes (2 x 16 x 8,192 x 256, GQA
  16/8, random normal inputs from seed 0; causal, and a 4,096 window), with
  softcap 50 and without, the variants timed in turns (forward, then
  backward), with its largest error against ``attention_ref`` and whether it
  holds phase 5's atol 1e-3 / rtol 2e-2 on these inputs.

A variant whose edit no longer applies to the source stops the script.
Exits nonzero without a CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention.cu"
OUT = ROOT / "build" / "attention_variants"

_EXP = ("          s[4 * nt + 2 * r] = expf(s[4 * nt + 2 * r] - mx);\n"
        "          s[4 * nt + 2 * r + 1] = expf(s[4 * nt + 2 * r + 1] - mx);")
_EXP2 = ("          s[4 * nt + 2 * r] = exp2f(fmaf(s[4 * nt + 2 * r], kLog2e, "
         "-mxl));\n"
         "          s[4 * nt + 2 * r + 1] =\n"
         "              exp2f(fmaf(s[4 * nt + 2 * r + 1], kLog2e, -mxl));")
_SUM = "        float sum = 0.f;\n#pragma unroll\n        for (int nt = 0;"

#: name -> (what it changes, [(committed text, replacement), ...])
VARIANTS = {
    "committed": ("the source as committed", []),
    "no_turns": (
        "the two warpgroups do not take turns on the tensor cores",
        [("    if (wg == 1) turn_wait();\n", ""),
         ("      if (wg == 0) turn_arrive();\n", ""),
         ("    } else if (wg == 0) {\n      turn_arrive();\n    }\n",
          "    }\n")]),
    "division": (
        "x / softcap as a division, not the reciprocal and fma step",
        [("          const float q1 = x * inv_cap;\n"
          "          x = softcap * tanhf(fmaf(fmaf(-softcap, q1, x), inv_cap, "
          "q1));\n",
          "          x = softcap * tanhf(x / softcap);\n")]),
    "exp2": (
        "exp2f of log2e-prescaled scores in place of expf (not exact)",
        [(_EXP, _EXP2),
         (_SUM, "        float sum = 0.f;\n"
                "        constexpr float kLog2e = 1.4426950408889634f;\n"
                "        const float mxl = mx * kLog2e;\n"
                "#pragma unroll\n        for (int nt = 0;")]),
    "single_p": (
        "P rounded to bf16 once: no P_lo product",
        [("        wgmma_rs(acc, pl[j], v_desc + ((j * 16 * 128) >> 4));\n",
          "")]),
}


def build(names):
    from repro_torch.kernels import runtime

    OUT.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    for name in names:
        src = text
        for old, new in VARIANTS[name][1]:
            if old not in src:
                raise SystemExit(f"variant {name}: its edit no longer "
                                 f"applies to {SOURCE.name}")
            src = src.replace(old, new)
        cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
        cu.write_text(src)
        cmd = [runtime.nvcc(), *runtime.NVCC_FLAGS, "-Xptxas", "-v",
               "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    built = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} does not build:\n{log}")
        built[name] = {"log": log, "path": str(so)}
    return built


def load(path):
    lib = ctypes.CDLL(path)
    lib.flash_attention.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                                    + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    lib.flash_attention.restype = ctypes.c_int
    return lib


def launcher(torch, lib):
    """The binding's launch, on ``lib``: bf16 q, k, v -> out."""
    def call(q, k, v, *, causal=True, window=0, softcap=0.0, sm_scale=None,
             kv_len=None):
        B, Hq, Sq, D = q.shape
        Hkv, Skv = k.shape[1], k.shape[2]
        out = torch.empty_like(q)
        rc = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
            Hkv, Sq, Skv, D, 1, int(causal), int(window),
            int(Skv if kv_len is None else min(kv_len, Skv)), float(softcap),
            float(D ** -0.5 if sm_scale is None else sm_scale),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed with code {rc}")
        return out
    return call


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("attention_variants: no CUDA card", file=sys.stderr)
        return 2
    for p in (ROOT, ROOT / "src", ROOT / "tests"):
        sys.path.insert(0, str(p))
    import chip_smoke
    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention import attention_ref
    from test_torch_gpu import ATTN_CASES, GEMMA2_CASE, _attn_inputs

    names = argv or list(VARIANTS)
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; "
                         f"known: {list(VARIANTS)}")
    print(chip_smoke.gpu_line(), flush=True)
    calls = {}
    for name, b in build(names).items():
        readings = chip_smoke.attention_build_readings(runtime, b)
        chip_smoke.emit({"variant": name, "what": VARIANTS[name][0],
                         "build": {k: {f: r.get(f) for f in (
                             "registers", "spill_store_bytes",
                             "spill_load_bytes", "tensor_core_instructions")}
                             for k, r in readings.items()
                             if k.startswith("bf16")}})
        calls[name] = launcher(torch, load(b["path"]))

    cuda = torch.device("cuda")
    cases = [c for c in ATTN_CASES + [GEMMA2_CASE] if c[9] == "bfloat16"]
    for name, call in calls.items():
        outside = []
        for i, case in enumerate(cases):
            *_, causal, window, softcap, _, extra = case
            q, k, v = _attn_inputs(case, cuda)
            kw = dict(causal=causal, window=window, softcap=softcap, **extra)
            got = call(q, k, v, **kw).float()
            want = attention_ref(q, k, v, **kw).float()
            if not torch.allclose(got, want, atol=2e-2, rtol=2e-2):
                outside.append(case[:6])
        chip_smoke.emit({"variant": name, "bf16_cases": len(cases),
                         "outside_2e-2": outside})

    g = torch.Generator(device=cuda).manual_seed(0)
    for window in (0, 4096):
        q = torch.randn((2, 16, 8192, 256), generator=g, device=cuda)
        k = torch.randn((2, 8, 8192, 256), generator=g, device=cuda)
        v = torch.randn((2, 8, 8192, 256), generator=g, device=cuda)
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        want = {cap: attention_ref(q, k, v, causal=True, window=window,
                                   softcap=cap).float() for cap in (50.0, 0.0)}
        order = list(calls) + list(calls)[::-1]
        rows = {name: {"variant": name, "window": window} for name in calls}
        for name in order:
            call, row = calls[name], rows[name]
            for cap in (50.0, 0.0):
                kw = dict(causal=True, window=window, softcap=cap)
                got = call(q, k, v, **kw).float()
                row.setdefault(f"ms_softcap{cap:g}", []).append(
                    chip_smoke.device_ms(torch, lambda: call(q, k, v, **kw)))
                row[f"max_abs_err_softcap{cap:g}"] = float(
                    (got - want[cap]).abs().max())
                row[f"within_phase5_tol_softcap{cap:g}"] = torch.allclose(
                    got, want[cap], atol=chip_smoke.ATTN_ATOL,
                    rtol=chip_smoke.ATTN_RTOL)
        for row in rows.values():
            chip_smoke.emit(row)
        del q, k, v, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
