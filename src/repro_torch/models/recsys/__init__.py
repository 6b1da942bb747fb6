"""Recommender models of the port: MIND (``mind``)."""
