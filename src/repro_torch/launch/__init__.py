"""Entry points: ``python -m repro_torch.launch.serve`` (the graph serving
loop) and ``launch.steps`` (the LM prefill and decode steps)."""
