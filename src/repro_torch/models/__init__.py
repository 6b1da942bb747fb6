"""Model surface of the port: the dense decoder-only LM (``transformer``)."""
