"""Roofline analysis of the dry run's records, from
``repro.launch.roofline``, against one NVIDIA H100's peaks.

Per (arch x shape x mesh) cell, the three roofline terms (seconds):

    compute    = flops               / PEAK_FLOPS
    memory     = bytes_accessed      / HBM_BW
    collective = collective_bytes    / LINK_BW

Every quantity of a ``launch.dryrun`` record is per device already (the
trace counts one device's local operators), so no term divides by the
device count.  The memory term reads the trace's ``bytes_accessed``, each
eager operator's inputs and outputs with nothing fused: about what eager
PyTorch moves, an upper bound on a fusing program's traffic (the
reference's XLA count is after fusion), so the table's memory column is a
pessimistic estimate, not a floor.

``bound_s`` is the floor a measured step is held to: the larger of the
compute term (the traced program's own flops, remat's recompute included,
at the bf16 peak) and a memory term that every program computing the
step must pay, each argument read once and each output written once
(``memory.argument_bytes + memory.output_bytes``).  ``eager_traffic_s``
reports ``bytes_accessed / HBM_BW`` beside it and bounds nothing.  Hardware model, one H100 SXM5 80 GB, from NVIDIA's data
sheets:

* ``PEAK_FLOPS`` 989e12: bf16 dense tensor-core FLOP/s (H100 Tensor Core
  GPU data sheet, SXM5; 1,979e12 is with sparsity).  Float32 cells are
  held to this bf16 peak too, as the reference holds every cell to its
  chip's bf16 peak: their compute term is a lower bound, not a forecast.
* ``HBM_BW`` 3.35e12 B/s: HBM3 (the same data sheet).
* ``LINK_BW`` 50e9 B/s a GPU: the inter-host NIC, one ConnectX-7 of 400
  Gb/s a GPU (DGX H100 data sheet).  A 16-wide mesh axis of H100s spans
  two 8-GPU hosts, so a collective over it (a ring) runs at the slowest
  hop's rate: the NIC's, not NVLink's 450 GB/s each way within a host.

Also reported: MODEL_FLOPS = 6 N D (dense) or 6 N_active D (MoE) a train
step, 2 N D a prefill, 2 N a decoded token per sequence (the GNN and
recsys families: their single-device trace's flops), the MODEL/traced
ratio (how much traced compute is "useful": catches recompute and
redundancy), the dominant term and a one-line note on what would move it.

These are predictions for an H100 from a trace, not measurements.

Usage:

  PYTHONPATH=src python -m repro_torch.launch.roofline \\
      [--dir experiments/dryrun_torch] [--md out.md] [--mesh pod]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Optional

PEAK_FLOPS = 989e12        # bf16 dense FLOP/s, one H100 SXM5
HBM_BW = 3.35e12           # HBM3 bytes/s, one H100 SXM5
LINK_BW = 50e9             # bytes/s a GPU across hosts (400 Gb/s NIC)

DEFAULT_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"


def _gnn_param_count(arch: str, cfg) -> int:
    """Parameters of a GNN's ``init_params``, built under
    ``FakeTensorMode`` (never materialised)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..core.tree import tree_leaves
    from .steps import _GNN

    module, _ = _GNN[arch]
    with FakeTensorMode():
        params = module.init_params(cfg, torch.Generator())
        return sum(int(p.numel()) for p in tree_leaves(params))


def model_flops_for(arch: str, shape_name: str, shape: Dict) -> float:
    """6 N D model FLOPs for the step (per the assignment's definition)."""
    from ..configs import get_arch
    m = get_arch(arch)
    if m.FAMILY == "lm":
        cfg = m.full_config()
        n = cfg.n_active_params() if cfg.is_moe else cfg.n_params()
        kind = shape["kind"]
        if kind == "train":
            tokens = shape["seq_len"] * shape["global_batch"]
            return 6.0 * n * tokens
        if kind == "prefill":
            tokens = shape["seq_len"] * shape["global_batch"]
            return 2.0 * n * tokens          # forward only
        # decode: one token per sequence
        return 2.0 * n * shape["global_batch"]
    if m.FAMILY == "gnn":
        # per-edge message cost dominates: FLOPs ~ 6 P_msg E (train)
        cfg = m.full_config() if arch != "pna" else m.full_config(
            d_in=shape.get("d_feat", 100) or 100)
        n_params = _gnn_param_count(arch, cfg)
        if shape["kind"] == "train_batched":
            units = shape["n_nodes"] * shape["batch"]
        elif shape["kind"] == "train_sampled":
            from ..configs.common import sampled_subgraph_size
            units = sampled_subgraph_size(shape)[0]
        else:
            units = shape["n_nodes"]
        return 6.0 * n_params * units / 100.0   # params touch ~1% of units
    # recsys
    cfg = m.full_config()
    dense = cfg.embed_dim * cfg.embed_dim      # routing matrix
    B = shape["batch"]
    if shape["kind"] == "train":
        return 6.0 * (dense + cfg.hist_len * cfg.embed_dim) * B
    return 2.0 * (dense + cfg.hist_len * cfg.embed_dim
                  + shape.get("n_candidates", 0) * cfg.embed_dim) * B


def analyse(rec: Dict) -> Optional[Dict]:
    """The three terms of one record; every quantity is per device."""
    if not rec.get("ok") or rec.get("skipped") or rec.get("measured"):
        return None
    n_dev = rec["n_devices"]
    cal = rec.get("cost_calibrated")
    if cal:
        flops = cal["flops"]
        byts = cal["bytes_accessed"]
        coll = cal["collective_bytes"]
    else:
        flops = rec["cost"]["flops"]
        byts = rec["cost"]["bytes_accessed"]
        coll = rec["collectives"]["total_bytes"]
    t_compute = flops / PEAK_FLOPS
    t_memory = byts / HBM_BW
    t_coll = coll / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)

    from ..configs import get_arch
    shape = get_arch(rec["arch"]).SHAPES[rec["shape"]]
    single = rec.get("cost_single_device")
    if single:
        # GNN/recsys: 'useful' = the unsharded single-device step's flops
        mflops = single["flops"]
    else:
        mflops = model_flops_for(rec["arch"], rec["shape"], shape)
    useful = mflops / max(flops * n_dev, 1.0)
    bound = max(terms.values())
    frac = (mflops / PEAK_FLOPS / n_dev) / max(bound, 1e-30)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops": mflops, "hlo_flops_total": flops * n_dev,
        "useful_ratio": useful, "roofline_fraction": min(frac, 1.0),
        "temp_gib": rec["memory"]["temp_bytes"] / 2 ** 30,
        "args_gib": rec["memory"]["argument_bytes"] / 2 ** 30,
        "peak_gib": (rec["memory"]["argument_bytes"]
                     + rec["memory"]["temp_bytes"]) / 2 ** 30,
    }


def floor_bytes(rec: Dict) -> int:
    """The bytes any program computing a record's step must move: each
    argument read once, each output written once."""
    mem = rec["memory"]
    return int(mem["argument_bytes"]) + int(mem["output_bytes"])


def bound_s(rec: Dict) -> float:
    """The least time one H100 could take for a single-device record's
    step (seconds): the larger of its flops at the bf16 peak and
    ``floor_bytes`` at the HBM rate."""
    return max(rec["cost"]["flops"] / PEAK_FLOPS,
               floor_bytes(rec) / HBM_BW)


def eager_traffic_s(rec: Dict) -> float:
    """The trace's unfused ``bytes_accessed`` at the HBM rate: what the
    eager operators move, reported beside ``bound_s``, never a bound."""
    return rec["cost"]["bytes_accessed"] / HBM_BW


def kernel_table(kernels: Dict[str, Dict]) -> str:
    """Achieved-against-peak table from MEASURED kernel counters.

    ``kernels`` is ``repro_torch.obs.kernel_summary()`` (or the
    ``"kernels"`` section of a ``launch/serve.py --metrics-json`` export):
    per (family.op[pool shape]) the steady-state wall seconds and the bytes
    moved.  Achieved bytes/s = bytes / steady_s, against one H100's HBM
    rate (dispatch wall time includes host and launch overhead, so the
    fraction is a lower bound on what the kernel body sustains)."""
    hdr = ("| kernel [pool shape] | calls | compile s | steady ms/call | "
           "GB moved | achieved GB/s | % HBM roof |")
    lines = [hdr, "|" + "---|" * 7]
    for key in sorted(kernels):
        s = kernels[key]
        steady_calls = max(1, int(s["steady_calls"]))
        steady_s = float(s["steady_s"])
        nbytes = float(s["bytes"])
        bps = nbytes / steady_s if steady_s > 0 else 0.0
        lines.append(
            f"| {key} | {int(s['calls'])} | {float(s['compile_s']):.3f} | "
            f"{1e3 * steady_s / steady_calls:.3f} | {nbytes / 1e9:.4f} | "
            f"{bps / 1e9:.2f} | {100.0 * bps / HBM_BW:.2f} |")
    return "\n".join(lines)


MOVE_NOTES = {
    "compute": "raise tensor-core utilisation: bf16 throughout, larger "
               "fused products, drop redundant recompute",
    "memory": "cut HBM traffic: fuse elementwise chains, bf16 activations, "
              "a better remat policy, flash-attention tiling",
    "collective": "cut wire bytes: reduce-scatter instead of all-reduce, "
                  "compressed gradients, shard-local dispatch, overlap",
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(DEFAULT_DIR))
    ap.add_argument("--md", default=None)
    ap.add_argument("--mesh", default="pod",
                    help="which mesh's table to print (pod = single-pod "
                         "roofline per the assignment)")
    ap.add_argument("--kernel-metrics", default=None, metavar="PATH",
                    help="achieved-against-peak table from MEASURED kernel "
                         "counters (a launch/serve.py --metrics-json "
                         "export) instead of the dry run's records")
    args = ap.parse_args(argv)

    if args.kernel_metrics:
        rec = json.loads(Path(args.kernel_metrics).read_text())
        kernels = rec.get("kernels", rec)
        table = kernel_table(kernels)
        print(table)
        if args.md:
            Path(args.md).write_text(table + "\n")
        return

    rows = []
    skipped = []
    for p in sorted(Path(args.dir).glob("*.json")):
        rec = json.loads(p.read_text())
        if rec.get("opts"):
            continue  # optimisation iterations: not the baseline table
        if rec.get("skipped"):
            skipped.append(rec)
            continue
        try:
            a = analyse(rec)
        except Exception:
            continue  # the graph plane's measured service cells
        if a and rec["mesh"] == args.mesh:
            rows.append(a)

    rows.sort(key=lambda r: r["roofline_fraction"])
    hdr = ("| arch | shape | peak GiB | compute s | memory s | collective s "
           "| dominant | MODEL/traced | roofline frac |")
    sep = "|" + "---|" * 9
    lines = [hdr, sep]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['peak_gib']:.2f} | "
            f"{r['t_compute_s']:.3e} | "
            f"{r['t_memory_s']:.3e} | {r['t_collective_s']:.3e} | "
            f"**{r['dominant']}** | {r['useful_ratio']:.2f} | "
            f"{r['roofline_fraction']:.3f} |")
    for s in skipped:
        if s["mesh"] == args.mesh:
            lines.append(f"| {s['arch']} | {s['shape']} | — | — | — | — | "
                         f"SKIP: {s['skipped']} | — | — |")
    table = "\n".join(lines)
    print(table)
    print()
    for dom, note in MOVE_NOTES.items():
        n = sum(1 for r in rows if r["dominant"] == dom)
        print(f"{dom}-bound cells: {n} — to improve: {note}")
    if args.md:
        Path(args.md).write_text(table + "\n")


if __name__ == "__main__":
    main()
