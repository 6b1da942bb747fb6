"""Meerkat's dynamic-graph serving loop in PyTorch, with CUDA kernels for
NVIDIA Hopper.

A port of the JAX package ``repro`` (the reference, which it never
imports): the pooled slab-hash graph (``core``), the batched update and
semiring-sweep engines (``kernels``), BFS/SSSP/PageRank (``algorithms``),
the versioned store, property registry and request pipeline (``stream``)
and the serving launcher (``launch.serve``).  Tensors live on ``cuda``
unless an entry point is given ``device="cpu"``; kernels run on CUDA
tensors and their plain PyTorch versions on CPU tensors.
"""
