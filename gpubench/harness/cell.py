"""One run of one cell: set-up, warm-up, the measured window, the check.

The deployment is booted as its configuration states, through the
program's own entry points (``GraphStore.from_edges``,
``PropertyRegistry``, ``RequestPipeline``), with each property built by
its kind's file (``gpubench/properties/<kind>.py``); the window is driven
by the client that the mix names (``gpubench/mixes/<client>.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import time
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np
import torch

from . import devtrace, graphs, work
from .check import RunLog, compare, judge, load_kind, substitute_controls
from .layers import Traced, load as load_layer
from .spans import all_spans, host_segments, label_time

SLAB_SOURCES = ("slab_update", "slab_sweep", "slab_pagerank", "slab_compact",
                "slab_intersect")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Manifest:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.bench = read_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return read_json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def mix(self, name: str) -> dict:
        return read_json(self.root / "gpubench" / "mixes" / f"{name}.json")

    def client(self, mix: dict):
        """The module of the client that the mix names."""
        path = self.root / "gpubench" / "mixes" / f"{mix['client']}.py"
        spec = importlib.util.spec_from_file_location(
            f"gpubench_client_{mix['client']}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def limits(self, cell: str) -> Dict[str, float]:
        path = self.root / "gpubench" / "limits" / f"{cell}.json"
        return read_json(path)["limits"]

    def metrics(self, cell: str, key: str) -> List[dict]:
        return [m for m in self.bench[key]
                if "workloads" not in m or cell in m["workloads"]]


def graph_of(cfg: dict) -> dict:
    """The configuration's generator parameters, with its scale."""
    return {**cfg["graph"], "scale": int(cfg["scale"])}


def draw_initial(graph: dict, device):
    """The initial edges (host int64 keys, sorted) and the id permutation
    (host, or None), drawn on ``device`` from the configuration's fixed
    ``graph_seed`` as GAP draws its graphs."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(graph["graph_seed"]))
    keys, perm = graphs.initial_edges(gen, graph)
    return keys.cpu(), None if perm is None else perm.cpu()


def warm_compaction(device) -> None:
    """Launch compaction's two kernels once on a two-row pool, so that the
    first compaction in the window loads nothing."""
    from repro_torch.kernels.slab_compact import chain_rank, slab_live
    keys = torch.full((2, 128), -2, dtype=torch.int32, device=device)
    owner = torch.arange(2, dtype=torch.int32, device=device)
    cnt, _ = slab_live(keys, owner)
    chain_rank(torch.full((2,), -1, dtype=torch.int32, device=device), cnt, 2)


class Session:
    """The deployment booted as the configuration states, with its initial
    edges and the log of what the window gives and answers."""

    def __init__(self, cfg: dict, mix: dict, kinds: Dict[str, object],
                 device, log: Callable[[str], None]):
        from repro_torch.stream import (GraphStore, MaintenancePolicy,
                                        PropertyRegistry, RequestPipeline)
        self.graph = graph_of(cfg)
        self.V = 1 << self.graph["scale"]
        self.batch = int(mix["batch"])
        self.device = device
        dep = cfg["deployment"]
        if dep["weighted"]:
            raise ValueError("a weighted deployment needs a generator and a "
                             "client that draw weights")
        t = time.perf_counter()
        self.initial, self.perm = draw_initial(self.graph, device)
        if device.type == "cuda":
            # the generator's temporaries are not the program's
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        self.runlog = RunLog(self.V, self.initial)
        log(f"[setup] generate {time.perf_counter() - t:.3f} s: "
            f"{self.initial.numel()} edges over {self.V} vertices")
        t = time.perf_counter()
        src = (self.initial // self.V).numpy().astype(np.uint32)
        dst = (self.initial % self.V).numpy().astype(np.uint32)
        self.store = GraphStore.from_edges(
            self.V, src, dst, hashing=dep["hashing"],
            with_transpose=dep["with_transpose"],
            with_symmetric=dep["with_symmetric"],
            slack_slabs=dep["slack_slabs"], log_capacity=dep["log_capacity"],
            maintenance=MaintenancePolicy(
                tombstone_ratio=dep["tombstone_ratio"]),
            device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        log(f"[setup] boot {time.perf_counter() - t:.3f} s: "
            f"{self.store.n_edges} live edges")
        t = time.perf_counter()
        self.properties = []
        for p in cfg["properties"]:
            kind = kinds[p["kind"]]
            resolved = kind.resolve(p, self) if hasattr(kind, "resolve") \
                else p
            if resolved != p:
                log(f"[setup] {p['name']}: " + ", ".join(
                    f"{k} {v}" for k, v in resolved.items() if k not in p))
            self.properties.append(resolved)
        self.registry = PropertyRegistry(self.store)
        for p in self.properties:
            # served under the configuration's name for it
            spec = dataclasses.replace(kinds[p["kind"]].spec(p, self),
                                       name=p["name"])
            self.registry.register(spec, policy=dep["policy"])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        log(f"[setup] first reads {time.perf_counter() - t:.3f} s")
        self.pipeline = RequestPipeline(self.store, self.registry)

    @staticmethod
    def host_value(value):
        """A served property value, copied to the host."""
        if isinstance(value, tuple):
            return tuple(v.detach().cpu().clone() for v in value)
        return value.detach().cpu().clone()


def checked_rounds(seed: int, mix: dict) -> set:
    """The rounds whose served properties are checked (besides the last
    one served), drawn from the seed among the window's first rounds."""
    rng = np.random.default_rng([int(seed), 1])
    first = int(mix["warmup_rounds"])
    return set(int(x) + first for x in rng.choice(
        int(mix["checked_from_first"]), int(mix["checked_rounds"]),
        replace=False))


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def count_bytes(root: Path, cfg: dict, mix: dict, kinds, client_mod,
                seed: int, n_rounds: int, device, log) -> Dict[str, int]:
    """Needed bytes per family of the traced window's rounds, counted in an
    untraced replay: the same deployment and seed, the same warm-up, then
    ``n_rounds`` rounds with the counters installed."""
    t = time.perf_counter()
    sess = Session(cfg, mix, kinds, device, lambda msg: None)
    client = client_mod.open_client(sess, mix, seed)
    client.prepare_rounds(int(mix["warmup_rounds"]) + n_rounds)
    for _ in range(int(mix["warmup_rounds"])):
        client.round()
    counter = work.Counter(work.families(root))
    counter.install()
    try:
        for _ in range(n_rounds):
            client.round()
    finally:
        counter.uninstall()
    totals = counter.totals()
    del sess, client, counter
    free(device)
    log(f"[replay] needed bytes of {n_rounds} rounds counted in "
        f"{time.perf_counter() - t:.3f} s")
    return totals


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float,
             log: Callable[[str], None], control: bool = False) -> dict:
    """One run; the result line's fields.  With ``control``, each
    property kind's control replaces what the program served before the
    check (``gpubench/control.py``)."""
    from repro_torch import obs
    from repro_torch.kernels import runtime

    man = Manifest(root)
    cell = man.cell(workload)
    cfg = man.config(cell["config"])
    mix = man.mix(cell["traffic"])
    client_mod = man.client(mix)
    kinds = {p["kind"]: load_kind(root, p["kind"])
             for p in cfg["properties"]}
    device = torch.device(device)
    if device.type == "cuda":
        t = time.perf_counter()
        built = runtime.build(SLAB_SOURCES)
        for name in SLAB_SOURCES:
            runtime.library(name)
        log(f"[setup] kernels {time.perf_counter() - t:.3f} s "
            f"(compiled: {sum(b['seconds'] > 0 for b in built.values())})")
    sess = Session(cfg, mix, kinds, device, log)
    client = client_mod.open_client(sess, mix, seed)
    t = time.perf_counter()
    n = client.prepare(seconds)
    log(f"[setup] requests {time.perf_counter() - t:.3f} s: {n} rounds")
    t = time.perf_counter()
    if device.type == "cuda":
        warm_compaction(device)
    for _ in range(int(mix["warmup_rounds"])):
        client.round()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log(f"[setup] warm-up {time.perf_counter() - t:.3f} s: "
        f"{mix['warmup_rounds']} rounds")

    checked = checked_rounds(seed, mix)
    if trace:
        obs.trace.reset()
        obs.enable(tracing=True, metric=False)
    launches0 = dict(runtime.LAUNCHES)
    client.failed = 0
    setup_s = time.perf_counter() - t_start
    # the device profile and the needed-bytes count cover the window's
    # first ``traced_rounds`` rounds (the stretch); the spans all of it
    stretch: Dict = {}
    prof = None

    def close_stretch(i, record, start):
        if trace and "rounds" not in stretch and \
                i + 1 >= int(mix["traced_rounds"]):
            lo, hi = int(start * 1e9), int(record[2] * 1e9)
            stretch.update(rounds=i + 1, span=(lo, hi),
                           dev=devtrace.stop(prof, (lo, hi)))

    if trace:
        prof = devtrace.start()
        t_mark = time.perf_counter_ns()
        obs.trace.instant("gpubench.window")

    window, rounds = client.window(seconds, checked, close_stretch)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launches = {k: v - launches0.get(k, 0) for k, v in runtime.LAUNCHES.items()
                if v - launches0.get(k, 0)}
    em = client_mod.window_metrics(window, rounds, client.edges_per_round)
    runlog = sess.runlog
    last = client.round_no - 1
    if last not in runlog.samples:
        # the last round served: its reads are the registry's states now
        runlog.samples[last] = {
            p["name"]: sess.host_value(sess.registry.read(p["name"]))
            for p in sess.properties if p["name"] in mix["reads"]}
    result: Dict = {"attempted": len(rounds) * client.requests_per_round,
                    "failed": client.failed}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": 1,
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated(
                       device) if device.type == "cuda" else 0)}
    live = sess.store.n_edges
    runlog.final_live = live
    properties = [p for p in sess.properties if p["name"] in mix["reads"]]
    metrics: Dict[str, Dict] = {}
    if trace:
        obs.disable()
        t = time.perf_counter()
        if "rounds" not in stretch:
            # the window ended before the stretch did
            done = [r for r in rounds if r[2] <= window[1]]
            lo, hi = int(window[0] * 1e9), int(window[1] * 1e9)
            stretch.update(rounds=len(done), span=(lo, hi),
                           dev=devtrace.stop(prof, (lo, hi)))
        dev = stretch["dev"]
        events = obs.trace.events()
        marks = [e for e in events if e["name"] == "gpubench.window"]
        shift = t_mark - marks[0]["ts_ns"] if marks else 0
        events = [{**e, "ts_ns": e["ts_ns"] + shift} for e in events]
        log(f"[trace] read in {time.perf_counter() - t:.3f} s")
    log(f"[window] {em['rounds']} rounds in {window[1] - window[0]:.3f} s, "
        f"{len(rounds)} served, {client.failed} failed, "
        f"{client.drawn_in_window} drawn inside it")
    # the program's state goes before the replay and the reference run
    del sess, client
    free(device)

    if trace:
        fams = work.families(root)
        lo, hi = stretch["span"]
        fam_ns: Dict[str, int] = {}
        if dev is not None:
            log(f"[trace] {len(dev)} of {dev.n_recorded} device activities "
                f"inside the first {stretch['rounds']} rounds' "
                f"{(hi - lo) * 1e-9:.3f} s")
            fam_ns = dev.time_by_group(
                lambda name: work.kernel_family(name, fams), hi)
        fam_bytes = count_bytes(root, cfg, mix, kinds, client_mod, seed,
                                stretch["rounds"], device, log)
        t = time.perf_counter()
        traced = Traced(rounds=em["rounds"], window_s=(hi - lo) * 1e-9,
                        spans=all_spans(events), launches=launches,
                        device=dev, family_ns=fam_ns, family_bytes=fam_bytes)
        for m in man.metrics(workload, "per_layer"):
            value = load_layer(root, m["name"]).read(traced)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if dev is not None:
            device_info["busy_s"] = dev.busy_ns() * 1e-9
            device_info["window_s"] = traced.window_s
            by_name = sorted(dev.time_by_name().items(),
                             key=lambda kv: -kv[1])[:10]
            idle = label_time(dev.gaps(), host_segments(events, lo, hi))
            result["breakdown"] = {
                "device_ops": [[n[:120], ns * 1e-9] for n, ns in by_name],
                "idle_gaps": [[n, ns * 1e-9] for n, ns in sorted(
                    idle.items(), key=lambda kv: -kv[1])[:10]]}
        log(f"[trace] per-layer metrics read in "
            f"{time.perf_counter() - t:.3f} s")
    else:
        values = {**em,
                  "bytes_per_edge": (device_info["memory_peak_bytes"] /
                                     max(live, 1)),
                  "setup_s": setup_s}
        for m in man.metrics(workload, "end_to_end"):
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}

    t = time.perf_counter()
    if control:
        replaced = substitute_controls(runlog, properties, kinds, device)
        log(f"[control] the reference one precision below in place of "
            f"{replaced}")
    numbers = compare(runlog, properties, kinds, device)
    correct, table = judge(numbers, man.limits(workload))
    log(f"[check] reference {time.perf_counter() - t:.3f} s over "
        f"{len(runlog.samples)} checked rounds {sorted(runlog.samples)}")
    result.update(correct=correct, metrics=metrics, device=device_info,
                  checks=table)
    return result
