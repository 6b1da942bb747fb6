"""Port parity: the roofline (``launch/roofline.py``) against
``repro.launch.roofline`` on the CPU.

* ``model_flops_for`` equals the reference's for all 40 assigned cells
  (the GNN parameter counts from ``init_params`` under ``FakeTensorMode``
  against ``jax.eval_shape``'s).
* ``analyse`` on the same records gives the reference's terms scaled by the
  ratio of the two sets of constants (one H100's 989e12 FLOP/s, 3.35e12
  B/s and 50e9 B/s against the reference's TPU v5e constants), the same
  model flops, useful ratio and sizes; the calibrated costs win where a
  record has them, and a skipped or measured record has no row.
* ``kernel_table`` on the same counters gives the same rows, its last
  column against the H100's HBM rate.
"""
import math

import pytest

import repro.configs as jconfigs
from repro.launch import roofline as jroof
from repro_torch.launch import roofline as troof

CELLS = [(a, s) for a, s, _ in jconfigs.all_cells(include_skipped=True)]


def test_constants_are_one_h100s():
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.LINK_BW) == \
        (989e12, 3.35e12, 50e9)


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_model_flops_match_reference(arch, shape):
    sh = jconfigs.get_arch(arch).SHAPES[shape]
    assert troof.model_flops_for(arch, shape, sh) == \
        jroof.model_flops_for(arch, shape, sh)


def _record(arch, shape, *, flops, byts, coll, n_dev=256, cal=None,
            single=None, mesh="pod"):
    return {"arch": arch, "shape": shape, "mesh": mesh, "ok": True,
            "n_devices": n_dev, "cost_calibrated": cal,
            "cost_single_device": single,
            "cost": {"flops": flops, "bytes_accessed": byts},
            "collectives": {"total_bytes": coll},
            "memory": {"argument_bytes": 3 * 2 ** 30,
                       "temp_bytes": 5 * 2 ** 30, "output_bytes": 0}}


RECORDS = [
    _record("gemma-2b", "train_4k", flops=2.1e14, byts=9.0e12, coll=4e11),
    _record("qwen3-moe-30b-a3b", "prefill_32k", flops=3.3e13, byts=2e12,
            coll=7e10, n_dev=512, mesh="multipod"),
    _record("gemma2-9b", "decode_32k", flops=1e12, byts=1e12, coll=1e8,
            cal={"flops": 4e12, "bytes_accessed": 3e12,
                 "collective_bytes": 2e9}),
    _record("mace", "ogb_products", flops=5e13, byts=4e12, coll=9e10,
            single={"flops": 1e16, "bytes_accessed": 1e15,
                    "collective_bytes": 0.0}),
    _record("mind", "train_batch", flops=3e11, byts=8e11, coll=3e10,
            single={"flops": 6e13, "bytes_accessed": 2e14,
                    "collective_bytes": 0.0}),
]


@pytest.mark.parametrize("rec", RECORDS, ids=lambda r: r["arch"])
def test_analyse_scales_the_reference_terms(rec):
    got, want = troof.analyse(rec), jroof.analyse(rec)
    scale = {"t_compute_s": jroof.PEAK_FLOPS / troof.PEAK_FLOPS,
             "t_memory_s": jroof.HBM_BW / troof.HBM_BW,
             "t_collective_s": jroof.ICI_BW / troof.LINK_BW}
    for key, k in scale.items():
        assert math.isclose(got[key], want[key] * k, rel_tol=1e-12), key
    for key in ("arch", "shape", "mesh", "model_flops", "hlo_flops_total",
                "useful_ratio", "temp_gib", "args_gib"):
        assert got[key] == want[key], key
    terms = {k[2:-2]: got[k] for k in scale}
    assert got["dominant"] == max(terms, key=terms.get)


def test_analyse_skips_what_has_no_terms():
    skipped = dict(RECORDS[0], skipped="no sub-quadratic path")
    measured = dict(RECORDS[0], measured=True)
    failed = dict(RECORDS[0], ok=False)
    for rec in (skipped, measured, failed):
        assert troof.analyse(rec) is None


def test_kernel_table_matches_reference():
    kernels = {
        "slab_sweep.sum[131072x128]": {"calls": 40, "steady_calls": 38,
                                       "compile_s": 0.8, "steady_s": 0.0046,
                                       "bytes": 2.4e9},
        "slab_update.probe[8192]": {"calls": 12, "steady_calls": 11,
                                    "compile_s": 0.1, "steady_s": 0.00035,
                                    "bytes": 6.1e7},
        "idle": {"calls": 1, "steady_calls": 0, "compile_s": 0.0,
                 "steady_s": 0.0, "bytes": 0.0},
    }
    got = troof.kernel_table(kernels).splitlines()
    want = jroof.kernel_table(kernels).splitlines()
    assert got[:2] == want[:2] and len(got) == len(want)
    for g, w in zip(got[2:], want[2:]):
        gc = [c.strip() for c in g.strip("|").split("|")]
        wc = [c.strip() for c in w.strip("|").split("|")]
        assert gc[:-1] == wc[:-1]
        assert math.isclose(float(gc[-1]),
                            float(wc[-1]) * jroof.HBM_BW / troof.HBM_BW,
                            abs_tol=0.006)


def test_bound_is_a_floor_not_the_eager_traffic():
    """``bound_s`` holds a step to its flops at the bf16 peak or its
    arguments and outputs once at the HBM rate, whichever is longer; the
    trace's unfused ``bytes_accessed`` (an upper bound on a fused
    program's traffic) moves only ``eager_traffic_s``."""
    rec = {"cost": {"flops": 9.89e13, "bytes_accessed": 3.35e14},
           "memory": {"argument_bytes": 6.7e11, "output_bytes": 0}}
    assert math.isclose(troof.bound_s(rec), 0.2)          # the arguments
    assert math.isclose(troof.eager_traffic_s(rec), 100.0)
    rec["memory"]["argument_bytes"] = 1e9
    assert math.isclose(troof.bound_s(rec), 0.1)          # the flops
    rec["cost"]["bytes_accessed"] *= 10
    assert math.isclose(troof.bound_s(rec), 0.1)
    rec["memory"]["output_bytes"] = 6.7e11
    assert troof.floor_bytes(rec) == int(1e9 + 6.7e11)
    assert math.isclose(troof.bound_s(rec), (1e9 + 6.7e11) / troof.HBM_BW)
