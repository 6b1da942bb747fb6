"""Model surface of the port: the decoder-only LM, dense and MoE
(``transformer``), MIND (``recsys.mind``) and the GNN family (``gnn``:
NequIP, MACE, PNA, EquiformerV2)."""
