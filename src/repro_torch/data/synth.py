"""Synthetic data, deterministic per seed: R-MAT power-law edge lists
(Graph500-style), LM token batches and recsys interaction batches.

The same generators as the reference's ``repro.data.synth``: the same numpy
draws in the same order, so one seed gives the same data in both packages.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np


def rmat_edges(n_vertices: int, n_edges: int, *, seed: int = 0,
               a: float = 0.57, b: float = 0.19, c: float = 0.19
               ) -> Tuple[np.ndarray, np.ndarray]:
    """``n_edges`` R-MAT draws over ``n_vertices``, self-loops dropped;
    (src, dst) as uint32."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(n_vertices, 2))))
    src = np.zeros(n_edges, dtype=np.int64)
    dst = np.zeros(n_edges, dtype=np.int64)
    for _ in range(scale):
        r = rng.random(n_edges)
        src_bit = (r >= a + b).astype(np.int64)
        r2 = rng.random(n_edges)
        dst_bit = np.where(src_bit == 0,
                           (r2 >= a / (a + b)).astype(np.int64),
                           (r2 >= c / (c + (1 - a - b - c) + 1e-12)
                            ).astype(np.int64))
        src = src * 2 + src_bit
        dst = dst * 2 + dst_bit
    src %= n_vertices
    dst %= n_vertices
    keep = src != dst
    return src[keep].astype(np.uint32), dst[keep].astype(np.uint32)


def uniform_edges(n_vertices: int, n_edges: int, *, seed: int = 0,
                  weighted: bool = False):
    """``n_edges`` uniform draws over ``n_vertices``, self-loops dropped;
    (src, dst) as uint32, and float32 weights in [0.1, 10) when
    ``weighted``."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, n_edges).astype(np.uint32)
    dst = rng.integers(0, n_vertices, n_edges).astype(np.uint32)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if weighted:
        return src, dst, rng.uniform(0.1, 10.0, len(src)).astype(np.float32)
    return src, dst


def edge_batches(src: np.ndarray, dst: np.ndarray, batch_size: int, *,
                 pad_to: Optional[int] = None
                 ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Fixed-shape batches of ``pad_to`` (default ``batch_size``) lanes:
    uint32 src and dst padded with 0xFFFFFFFF, and the mask of real
    lanes."""
    cap = pad_to or batch_size
    for i in range(0, len(src), batch_size):
        s = src[i:i + batch_size]
        d = dst[i:i + batch_size]
        ps = np.full(cap, 0xFFFFFFFF, np.uint32)
        pd = np.full(cap, 0xFFFFFFFF, np.uint32)
        ps[:len(s)] = s
        pd[:len(d)] = d
        yield ps, pd, np.arange(cap) < len(s)


def lm_batches(vocab_size: int, batch: int, seq_len: int, *,
               seed: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Synthetic next-token data: Zipf-ish tokens (batch, seq_len) int32 and
    their labels, the tokens shifted by one."""
    rng = np.random.default_rng(seed)
    while True:
        z = rng.zipf(1.3, size=(batch, seq_len + 1)) % vocab_size
        yield z[:, :-1].astype(np.int32), z[:, 1:].astype(np.int32)


def recsys_batches(n_items: int, batch: int, hist_len: int, *,
                   seed: int = 0
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Synthetic interaction data: Zipf-ish item histories (batch, hist_len)
    int32, a float32 mask of each history's first ``lens`` slots (lens
    uniform in 1..hist_len) and a target item per row."""
    rng = np.random.default_rng(seed)
    while True:
        hist = (rng.zipf(1.2, size=(batch, hist_len)) % n_items) \
            .astype(np.int32)
        lens = rng.integers(1, hist_len + 1, batch)
        mask = (np.arange(hist_len)[None] < lens[:, None]).astype(np.float32)
        target = (rng.zipf(1.2, size=batch) % n_items).astype(np.int32)
        yield hist, mask, target
