"""Dynamic graph algorithms on the port's core: BFS, SSSP, PageRank, WCC and
triangle counting.
Each ``stream_property`` hook (re-exported as ``<algo>_stream_property``)
packages an incremental maintainer for the stream registry."""
from .bfs import (UNREACHED, bfs_decremental, bfs_incremental,
                  bfs_tree_static, bfs_vanilla)
from .bfs import stream_property as bfs_stream_property
from .pagerank import pagerank, pagerank_dynamic, slab_contrib_sums_ref
from .pagerank import stream_property as pagerank_stream_property
from .sssp import (INF, NO_PARENT, TreeState, init_state, relax_edges,
                   relax_sweep, run_to_convergence, sssp_decremental,
                   sssp_incremental, sssp_static, tree_state_like)
from .sssp import stream_property as sssp_stream_property
from .triangle import (batch_graph, count_kernel, search_edges,
                       triangles_decremental, triangles_incremental,
                       triangles_static, undirected_host)
from .triangle import stream_property as triangle_stream_property
from .wcc import (count_components, wcc_incremental_batch,
                  wcc_incremental_naive, wcc_incremental_slab_iterator,
                  wcc_incremental_update_iterator, wcc_labelprop_ref,
                  wcc_labelprop_sweep, wcc_static)
from .wcc import stream_property as wcc_stream_property

__all__ = ["UNREACHED", "bfs_decremental", "bfs_incremental",
           "bfs_tree_static", "bfs_vanilla", "bfs_stream_property",
           "pagerank", "pagerank_dynamic", "slab_contrib_sums_ref",
           "pagerank_stream_property", "INF", "NO_PARENT", "TreeState",
           "init_state", "relax_edges", "relax_sweep", "run_to_convergence",
           "sssp_decremental", "sssp_incremental", "sssp_static",
           "sssp_stream_property", "tree_state_like",
           "batch_graph", "count_kernel", "search_edges",
           "triangles_decremental", "triangles_incremental",
           "triangles_static", "undirected_host", "triangle_stream_property",
           "count_components", "wcc_incremental_batch",
           "wcc_incremental_naive", "wcc_incremental_slab_iterator",
           "wcc_incremental_update_iterator", "wcc_labelprop_ref",
           "wcc_labelprop_sweep", "wcc_static", "wcc_stream_property"]
