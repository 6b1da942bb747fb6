"""Training launcher, from ``repro.launch.train``:

    python -m repro_torch.launch.train --arch gemma-2b --device cpu \\
        --steps 20 --ckpt-dir /tmp/ckpt

Runs real steps of an LM (``build_lm_train_step``), a GNN
(``build_gnn_train_step``) or MIND (``build_mind_train_step``) on
``--device`` (``cuda`` unless the caller passes ``cpu``; the kernels run
on the card, their plain versions on the CPU), through
``train.loop.train``: fault-tolerant by construction, it resumes from the
newest checkpoint under ``--ckpt-dir``.  That defaults to
``repro_torch_ckpt_<arch>`` under ``tempfile.gettempdir()`` (``$TMPDIR``),
not the reference's fixed ``/tmp/repro_ckpt`` that every arch shares, so
re-running one arch's command resumes it and no other arch's run restores
into it.  Weights come from a generator seeded with 0 on the device,
batches from ``data.synth``; a GNN's from the random builders of
``models.gnn.common``, batch ``i`` from a generator seeded with ``i``
(molecule-like geometric batches of 64 nodes, 256 edges and 4 graphs, or
feature graphs of 128 nodes and 512 edges).

``--smoke`` is declared as the reference declares it (``store_true`` with
``default=True``), so the command line always trains the smoke config, as
the reference's does.  The graph family is served, not trained: it exits
with a message.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Dict

import numpy as np

#: the reference's architecture this launcher does not train: the graph
#: plane, which is served
GRAPH_ARCHS = ("meerkat-graph",)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_ckpt_<arch> under $TMPDIR")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="reduced config (the reference's flag: always on)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    if args.ckpt_dir is None:
        args.ckpt_dir = os.path.join(tempfile.gettempdir(),
                                     f"repro_torch_ckpt_{args.arch}")
    return args


def main(argv=None) -> Dict:
    args = parse_args(argv)
    import torch

    from ..configs import get_arch
    from ..core.device import resolve_device
    from ..data.synth import lm_batches, recsys_batches
    from ..launch import steps as S
    from ..models import transformer as tfm
    from ..models.gnn.common import (random_feature_graph,
                                     random_geometric_batch)
    from ..train import optimizer as opt
    from ..train.loop import train

    if args.arch in GRAPH_ARCHS:
        raise SystemExit(f"use examples/streaming_analytics.py or "
                         f"repro_torch.launch.serve for {args.arch}")
    dev = resolve_device(args.device)
    m = get_arch(args.arch)
    cfg = m.smoke_config() if args.smoke else m.full_config()
    gen = torch.Generator(device=dev).manual_seed(0)

    if m.FAMILY == "lm":
        params = tfm.init_params(cfg, gen)
        step = S.build_lm_train_step(cfg)

        def data():
            for toks, labels in lm_batches(cfg.vocab_size, args.batch,
                                           args.seq_len):
                yield (torch.from_numpy(toks).to(dev),
                       torch.from_numpy(labels).to(dev))
    elif m.FAMILY == "gnn":
        module, style = S._GNN[args.arch]
        params = module.init_params(cfg, gen)
        step = S.build_gnn_train_step(module, cfg, style)

        def data():
            i = 0
            while True:
                g = torch.Generator(device=dev).manual_seed(i)
                if style == "geometric":
                    b = random_geometric_batch(g, 64, 256, n_graphs=4,
                                               n_species=cfg.n_species)
                    t = torch.randn((4,), generator=g, device=dev)
                else:
                    b = random_feature_graph(g, 128, 512, cfg.d_in)
                    t = torch.randint(0, cfg.n_classes, (128,),
                                      generator=g, device=dev)
                yield b, t
                i += 1
    else:
        from ..models.recsys import mind as mind_m
        params = mind_m.init_params(cfg, gen)
        step = S.build_mind_train_step(cfg)

        def data():
            for h, msk, t in recsys_batches(cfg.n_items, args.batch,
                                            cfg.hist_len):
                yield (torch.from_numpy(h).to(dev),
                       torch.from_numpy(msk).to(dev),
                       torch.from_numpy(t).to(dev))

    ostate = opt.init(params)
    print(f"[train] {args.arch}: checkpoints in {args.ckpt_dir}")
    out = train(step, params, ostate, data(), ckpt_dir=args.ckpt_dir,
                max_steps=args.steps, ckpt_every=args.ckpt_every)
    losses = out["losses"]
    if losses:
        print(f"[train] done: first-10 loss {np.mean(losses[:10]):.4f} → "
              f"last-10 loss {np.mean(losses[-10:]):.4f}")
    return out


if __name__ == "__main__":
    main()
