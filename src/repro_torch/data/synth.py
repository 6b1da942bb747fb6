"""R-MAT power-law edge lists (Graph500-style), deterministic per seed.

The same generator as the reference's ``repro.data.synth.rmat_edges``: the
same numpy draws in the same order, so one seed gives the same graph in
both packages.
"""
from __future__ import annotations

from typing import Tuple

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
