"""Needed bytes of compaction's two pool-wide passes (``slab_live`` and
``chain_rank``, ``csrc/slab_compact.cu``).

The live census reads each live key and writes its rank (8 B a live lane)
and reads each allocated row's owner and writes its count (8 B a row).
The chain walk reads each row's link and count (8 B) and writes three
int32 a row and one count a bucket; its call carries no owners, so it is
held to every row of the pool.
"""
HOOKS = {("repro_torch.kernels.slab_compact.ops", "slab_live"): "live_bytes",
         ("repro_torch.kernels.slab_compact.ops", "chain_rank"): "rank_bytes"}
KERNELS = (r"\blive_kernel\b", r"\bchain_init_kernel\b", r"\bchain_kernel\b",
           r"\blong_chain_kernel\b")


def live_bytes(result, keys, slab_vertex):
    live = (keys >= 0).sum()
    return 8 * live + 8 * (slab_vertex[:keys.shape[0]] >= 0).sum()


def rank_bytes(result, next_slab, live_count, n_buckets):
    return 20 * next_slab.shape[0] + 4 * n_buckets
