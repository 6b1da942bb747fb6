"""GNN family of the port, from ``repro.models.gnn``: the shared substrate
(``common``: graph batches, radial bases, segment message passing,
``edges_from_slab`` over a live ``SlabGraph``), the SO(3) algebra
(``irreps``), the tensor-product machinery (``tensor_field``) and the four
models: ``nequip``, ``mace``, ``pna`` and ``equiformer_v2``."""
