#!/usr/bin/env python3
"""Build variants of the flash-attention source and hold each beside the
committed kernel on one CUDA card.

    python3 tools/attention_variants.py [--dtype bf16|f32] [--parent DIR]
                                        [variant ...]

Each variant is the committed ``src/repro_torch/csrc/flash_attention.cu``
with a few lines edited (``VARIANTS`` for the bf16 kernel, ``F32_VARIANTS``
for the float32 one); ``--parent`` adds the source of another checkout (an
unpacked earlier commit; repeatable) unedited, under its directory's name.
All are compiled in parallel with ``ptxas -v`` into
``build/attention_variants/`` and loaded with ctypes (the C entry point is
the committed one's).  For each, the script prints:

* the registers and spill bytes of every instantiation of the chosen
  dtype, and for bf16 its tensor-core instruction count
  (``chip_smoke.attention_build_readings``);
* which cases of that dtype of the card test (``ATTN_CASES``, and for bf16
  the gemma2 case of ``tests/test_torch_gpu.py``) fall outside the test's
  tolerance of ``attention_ref`` (2e-2 in bf16, 2e-5 in float32);
* its device time on gemma2-9b's layer shapes (2 x 16 x 8,192 x 256, GQA
  16/8, random normal inputs from seed 0; causal, and a 4,096 window), the
  variants timed in turns (forward, then backward), with its largest error
  against ``attention_ref`` and whether it holds phase 5's tolerance on
  these inputs (bf16: atol 1e-3 / rtol 2e-2, with softcap 50 and without;
  float32: 2e-5, softcap 50).

A variant whose edit no longer applies to the source stops the script;
one that does not build is printed with its log and left out.
Exits nonzero without a CUDA card.
"""
from __future__ import annotations

import argparse
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
          "q1));\n        }\n        s[i] = x;",
          "          x = softcap * tanhf(x / softcap);\n        }\n"
          "        s[i] = x;")]),
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

_F32_S_LOOP = ("#pragma unroll 4\n"
               "      for (int d = 0; d < kHalf; d += 2) {")
_F32_PV_LOOP = "#pragma unroll 1\n    for (int kk = 0; kk < kBK; kk += 4) {"
_F32_V_COPY = ("    copy_rows<D, kBK, D>(vs_s, vh, k0, kv_len);  // lands "
               "during S_t\n    cp_async_commit();\n")
_F32_K_COPY = "    cp_async_commit();\n    if (!live) continue;\n"
_F32_Q_LOAD = ("          qv[i] = *reinterpret_cast<const float2*>(qrow + 2 * i "
               "* kStride + d);\n")
_F32_K_LOAD = ("          kv[j] = *reinterpret_cast<const float2*>(krow + 8 * j "
               "* kStride + d);\n")
_F32_FMA_Y = "            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);\n"
_F32_BQ64 = ("constexpr int kBQ = 128;", "constexpr int kBQ = 64;")

#: the score block of the committed kernel (8 x 4 partial scores a lane over
#: half of the head dims, joined by a shuffle) -> a 4 x 4 tile a lane over
#: all of them: the lane computes the very rows it keeps for the softmax
_F32_TILE4X4 = [
    ("  const float* qrow = Qs + (warp * kWarpRows + rg) * kStride + hf * "
     "kHalf;\n  const float* krow = Ks + kg * kStride + hf * kHalf;\n",
     "  const float* qrow = Qs + (warp * kWarpRows + rg + 8 * hf) * kStride;\n"
     "  const float* krow = Ks + kg * kStride;\n"),
    ("      float s[8][4];\n", ""),
    ("#pragma unroll\n      for (int i = 0; i < 8; ++i)\n#pragma unroll\n"
     "        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;\n", ""),
    ("      for (int d = 0; d < kHalf; d += 2) {\n        float2 qv[8], kv[4];",
     "      for (int d = 0; d < D; d += 2) {\n        float2 qv[4], kv[4];"),
    ("#pragma unroll\n        for (int i = 0; i < 8; ++i)\n" + "          qv[i]",
     "#pragma unroll\n        for (int i = 0; i < 4; ++i)\n" + "          qv[i]"),
    ("#pragma unroll\n        for (int i = 0; i < 8; ++i)\n#pragma unroll\n"
     "          for (int j = 0; j < 4; ++j) {\n"
     "            s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);\n"
     "            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);\n",
     "#pragma unroll\n        for (int i = 0; i < 4; ++i)\n#pragma unroll\n"
     "          for (int j = 0; j < 4; ++j) {\n"
     "            sm[i][j] = fmaf(qv[i].x, kv[j].x, sm[i][j]);\n"
     "            sm[i][j] = fmaf(qv[i].y, kv[j].y, sm[i][j]);\n"),
    ("      // the two halves meet: lane hf sends the rows it does not keep\n"
     "#pragma unroll\n      for (int i = 0; i < 4; ++i)\n#pragma unroll\n"
     "        for (int j = 0; j < 4; ++j) {\n"
     "          const float mine = hf ? s[4 + i][j] : s[i][j];\n"
     "          const float sent = hf ? s[i][j] : s[4 + i][j];\n"
     "          sm[i][j] = mine + __shfl_xor_sync(kFull, sent, 16);\n"
     "        }\n", ""),
]

#: a 2-stage ring of K and V tiles: tile t + 1's K and V are copied while
#: tile t is worked on, one barrier a tile.  It fits 227 KB at D = 256 only
#: with 64-row query tiles, so it goes with ``bq64``.
_F32_RING2 = [
    _F32_BQ64,
    ("  static constexpr int kK = kBK * kStride;\n"
     "  static constexpr int kV = kBK * D;\n",
     "  static constexpr int kK = 2 * kBK * kStride;\n"
     "  static constexpr int kV = 2 * kBK * D;\n"),
    ("  if (n_kt > 0) copy_rows<D, kBK, kStride>(ks_s, kh, kt0 * kBK, "
     "kv_len);\n",
     "  if (n_kt > 0) {\n"
     "    copy_rows<D, kBK, kStride>(ks_s, kh, kt0 * kBK, kv_len);\n"
     "    copy_rows<D, kBK, D>(vs_s, vh, kt0 * kBK, kv_len);\n  }\n"),
    ("    const int k0 = (kt0 + it) * kBK;\n    cp_async_wait<0>();\n"
     "    __syncthreads();  // K_t has landed; every warp is done with "
     "V_{t-1}\n" + _F32_V_COPY,
     "    const int k0 = (kt0 + it) * kBK, st = it & 1;\n"
     "    cp_async_wait<0>();\n"
     "    __syncthreads();  // tile t has landed; all are done with t - 1\n"
     "    if (it + 1 < n_kt) {\n"
     "      const uint32_t nx = 4u * kBK * static_cast<uint32_t>(st ^ 1);\n"
     "      copy_rows<D, kBK, kStride>(ks_s + nx * kStride, kh, k0 + kBK,\n"
     "                                 kv_len);\n"
     "      copy_rows<D, kBK, D>(vs_s + nx * D, vh, k0 + kBK, kv_len);\n"
     "    }\n    cp_async_commit();\n"),
    ("    cp_async_wait<0>();\n"
     "    __syncthreads();  // V_t has landed; every warp is done with K_t\n"
     "    if (it + 1 < n_kt)  // K_{t+1} lands during this tile's softmax and "
     "P V\n"
     "      copy_rows<D, kBK, kStride>(ks_s, kh, k0 + kBK, kv_len);\n"
     "    cp_async_commit();\n    if (!live) continue;\n",
     "    if (!live) continue;\n"),
    (_F32_K_LOAD, _F32_K_LOAD.replace("krow + 8 * j * kStride",
                                      "krow + (st * kBK + 8 * j) * kStride")),
    ("const float* vrow = Vs + (kk + t) * D + 4 * cg;",
     "const float* vrow = Vs + (st * kBK + kk + t) * D + 4 * cg;"),
]

#: the float32 kernel's design choices, as edits of the committed source
F32_VARIANTS = {
    "committed": ("the source as committed", []),
    "s_float4": ("float4 loads in the score loop, not float2",
                 [(_F32_S_LOOP, _F32_S_LOOP.replace("d += 2", "d += 4")),
                  ("        float2 qv[8], kv[4];",
                   "        float4 qv[8], kv[4];"),
                  (_F32_Q_LOAD, _F32_Q_LOAD.replace("float2", "float4")),
                  (_F32_K_LOAD, _F32_K_LOAD.replace("float2", "float4")),
                  (_F32_FMA_Y, _F32_FMA_Y
                   + _F32_FMA_Y.replace(".y", ".z")
                   + _F32_FMA_Y.replace(".y", ".w"))]),
    "tile4x4": ("a 4 x 4 score tile a lane over all of the head dims (16 "
                "floats loaded for 32 fmas), no shuffle join",
                _F32_TILE4X4),
    "bq64": ("64-row query tiles, 4 warps a block: K and V read twice as "
             "often", [_F32_BQ64]),
    "ring2_bq64": ("64-row query tiles and a 2-stage ring of K and V: the "
                   "next tile's copy spans the whole of this tile's work",
                   _F32_RING2),
    "serial_copies": (
        "each copy waited for where it is issued: no copy overlaps a "
        "product",
        [(_F32_V_COPY, _F32_V_COPY + "    cp_async_wait<0>();\n"),
         (_F32_K_COPY, "    cp_async_commit();\n    cp_async_wait<0>();\n"
                       "    if (!live) continue;\n")]),
    "mask_always": (
        "the mask on every tile, not only where the band's edge crosses",
        [("bool live = wq0 < Sq, edge = k0 + kBK > kv_len;",
          "bool live = wq0 < Sq, edge = true;")]),
    "no_warp_skip": (
        "every warp computes every tile of its block",
        [("      live = live && k0 <= wq0 + kWarpRows - 1;\n", ""),
         ("      live = live && wq0 - (k0 + kBK - 1) < window;\n", "")]),
    "s_unroll2": ("the score loop unrolled 2 steps, not 4",
                  [(_F32_S_LOOP, _F32_S_LOOP.replace("4\n", "2\n", 1))]),
    "s_unroll8": ("the score loop unrolled 8 steps, not 4",
                  [(_F32_S_LOOP, _F32_S_LOOP.replace("4\n", "8\n", 1))]),
    "pv_unroll2": ("the P V loop unrolled 2 steps, not 1",
                   [(_F32_PV_LOOP, _F32_PV_LOOP.replace("1\n", "2\n", 1))]),
    "division": (
        "x / softcap as a division, not the reciprocal and fma step",
        [("          const float q1 = x * inv_cap;\n"
          "          x = softcap * tanhf(fmaf(fmaf(-softcap, q1, x), inv_cap, "
          "q1));\n        }\n        sm[i][j] = x;",
          "          x = softcap * tanhf(x / softcap);\n        }\n"
          "        sm[i][j] = x;")]),
    "rescale_when_needed": (
        "O rescaled only when some row of the warp has a new max",
        [("#pragma unroll\n    for (int i = 0; i < 8; ++i) {\n"
          "      const float a = elem(i < 4 ? a_lo : a_hi, i & 3);\n"
          "#pragma unroll\n"
          "      for (int c = 0; c < 4 * kGroups; ++c) acc[i][c] *= a;\n"
          "    }\n",
          "    if (__any_sync(kFull, a_lo.x != 1.f || a_lo.y != 1.f ||\n"
          "                          a_lo.z != 1.f || a_lo.w != 1.f ||\n"
          "                          a_hi.x != 1.f || a_hi.y != 1.f ||\n"
          "                          a_hi.z != 1.f || a_hi.w != 1.f)) {\n"
          "#pragma unroll\n    for (int i = 0; i < 8; ++i) {\n"
          "      const float a = elem(i < 4 ? a_lo : a_hi, i & 3);\n"
          "#pragma unroll\n"
          "      for (int c = 0; c < 4 * kGroups; ++c) acc[i][c] *= a;\n"
          "    }\n    }\n")]),
    # not the function: where the time goes
    "no_scores": ("(not the function) the score products left out",
                  [(_F32_S_LOOP, _F32_S_LOOP.replace("d < kHalf", "d < 0"))]),
    "no_pv": ("(not the function) the P V products left out",
              [(_F32_PV_LOOP, _F32_PV_LOOP.replace("kk < kBK", "kk < 0"))]),
    "no_products": ("(not the function) both products left out",
                    [(_F32_S_LOOP, _F32_S_LOOP.replace("d < kHalf", "d < 0")),
                     (_F32_PV_LOOP, _F32_PV_LOOP.replace("kk < kBK",
                                                         "kk < 0"))]),
}


def build(names, variants, parents=()):
    """Compile each named variant, and the source of each checkout in
    ``parents`` unedited (named by its directory), in parallel -> {name:
    {"log", "path"}}; a build that fails is printed and left out."""
    from repro_torch.kernels import runtime

    OUT.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    sources = {}
    for name in names:
        src = text
        for old, new in variants[name][1]:
            if old not in src:
                raise SystemExit(f"variant {name}: its edit no longer "
                                 f"applies to {SOURCE.name}")
            src = src.replace(old, new)
        sources[name] = src
    for parent in parents:
        source = Path(parent) / SOURCE.relative_to(ROOT)
        sources[Path(parent).name] = source.read_text()
    procs = {}
    for name, src in sources.items():
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
            print(json.dumps({"variant": name, "build_failed": log[-4000:]}),
                  flush=True)
            continue
        built[name] = {"log": log, "path": str(so)}
    return built


def load(path):
    lib = ctypes.CDLL(path)
    # the trailing lse pointer (null here) is ignored by builds before it
    lib.flash_attention.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                                    + [ctypes.c_float] * 2
                                    + [ctypes.c_void_p] * 2)
    lib.flash_attention.restype = ctypes.c_int
    return lib


def launcher(torch, lib):
    """The binding's launch, on ``lib``: q, k, v (bf16 or float32) -> out."""
    def call(q, k, v, *, causal=True, window=0, softcap=0.0, sm_scale=None,
             kv_len=None):
        B, Hq, Sq, D = q.shape
        Hkv, Skv = k.shape[1], k.shape[2]
        out = torch.empty_like(q)
        rc = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
            Hkv, Sq, Skv, D, int(q.dtype == torch.bfloat16), int(causal),
            int(window),
            int(Skv if kv_len is None else min(kv_len, Skv)), float(softcap),
            float(D ** -0.5 if sm_scale is None else sm_scale),
            torch.cuda.current_stream().cuda_stream, None)
        if rc:
            raise RuntimeError(f"launch failed with code {rc}")
        return out
    return call


def bf16_turns(torch, chip_smoke, attention_ref, calls):
    """The bf16 variants on gemma2-9b's layer shapes, with softcap 50 and
    without, in turns."""
    cuda = torch.device("cuda")
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


def f32_turns(torch, chip_smoke, attention_ref, calls):
    """The float32 variants on gemma2-9b's layer shapes with softcap 50 (the
    float32 serve's global and local layers), in turns."""
    cuda = torch.device("cuda")
    g = torch.Generator(device=cuda).manual_seed(0)
    tol = chip_smoke.ATTN_F32_ATOL
    for window in (0, 4096):
        q = torch.randn((2, 16, 8192, 256), generator=g, device=cuda)
        k = torch.randn((2, 8, 8192, 256), generator=g, device=cuda)
        v = torch.randn((2, 8, 8192, 256), generator=g, device=cuda)
        kw = dict(causal=True, window=window, softcap=50.0)
        want = attention_ref(q, k, v, **kw)
        rows = {name: {"variant": name, "window": window, "ms": []}
                for name in calls}
        for name in calls:
            got = calls[name](q, k, v, **kw)
            rows[name]["max_abs_err"] = float((got - want).abs().max())
            rows[name]["within_2e-5"] = torch.allclose(got, want, atol=tol,
                                                       rtol=tol)
            del got
        for name in list(calls) + list(calls)[::-1]:
            rows[name]["ms"].append(chip_smoke.device_ms(
                torch, lambda: calls[name](q, k, v, **kw), warmup=1,
                samples=5))
        for row in rows.values():
            chip_smoke.emit(row)
        del q, k, v, want
        torch.cuda.empty_cache()


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--parent", type=Path, action="append", default=[],
                    help="an unpacked earlier checkout, built unedited under "
                         "its directory's name (repeatable)")
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args(argv)
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

    variants = VARIANTS if args.dtype == "bf16" else F32_VARIANTS
    names = args.variants or list(variants)
    unknown = set(names) - set(variants)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; "
                         f"known: {list(variants)}")
    torch.backends.cuda.matmul.allow_tf32 = False   # a float32 reference
    print(chip_smoke.gpu_line(), flush=True)
    calls = {}
    for name, b in build(names, variants, args.parent).items():
        readings = chip_smoke.attention_build_readings(runtime, b)
        chip_smoke.emit({"variant": name,
                         "what": variants.get(name, ("an earlier "
                                                     "checkout's source",))[0],
                         "build": {k: {f: r.get(f) for f in (
                             "registers", "spill_store_bytes",
                             "spill_load_bytes", "tensor_core_instructions")}
                             for k, r in readings.items()
                             if k.startswith(args.dtype)}})
        calls[name] = launcher(torch, load(b["path"]))

    cuda = torch.device("cuda")
    dtype = "bfloat16" if args.dtype == "bf16" else "float32"
    tol = 2e-2 if args.dtype == "bf16" else 2e-5
    cases = [c for c in ATTN_CASES + [GEMMA2_CASE] if c[9] == dtype]
    for name, call in calls.items():
        outside = []
        for case in cases:
            *_, causal, window, softcap, _, extra = case
            q, k, v = _attn_inputs(case, cuda)
            kw = dict(causal=causal, window=window, softcap=softcap, **extra)
            got = call(q, k, v, **kw).float()
            want = attention_ref(q, k, v, **kw).float()
            if not torch.allclose(got, want, atol=tol, rtol=tol):
                outside.append(case[:6])
        chip_smoke.emit({"variant": name, f"{args.dtype}_cases": len(cases),
                         f"outside_{tol:g}": outside})

    turns = bf16_turns if args.dtype == "bf16" else f32_turns
    turns(torch, chip_smoke, attention_ref, calls)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
