"""Model surface of the port: the decoder-only LM, dense and MoE
(``transformer``), and MIND's serving path (``recsys.mind``)."""
