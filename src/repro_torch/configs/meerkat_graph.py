"""meerkat-graph, from ``repro.configs.meerkat_graph``: the paper's own
technique as a distributed config.

Dynamic graph analytics serving: batched edge updates and incremental
PageRank over a vertex-partitioned SlabGraph (the service cell beyond the
40 assigned arch x shape cells).  ``stream_10k`` inserts a 10,240-edge
batch; ``analytics_pr`` runs 20 PageRank iterations; both at 2**20
vertices and 2**17 slabs (64 MiB of keys).
"""
ARCH_ID = "meerkat-graph"
FAMILY = "graph"
SHAPES = {
    "stream_10k": {"kind": "graph_update", "n_vertices": 1 << 20,
                   "batch": 10240, "capacity_slabs": 1 << 17},
    "analytics_pr": {"kind": "graph_pagerank", "n_vertices": 1 << 20,
                     "capacity_slabs": 1 << 17},
}
SKIP = {}


def full_config():
    return {"n_vertices": 1 << 20, "capacity_slabs": 1 << 17}


def smoke_config():
    return {"n_vertices": 1 << 10, "capacity_slabs": 1 << 11}
