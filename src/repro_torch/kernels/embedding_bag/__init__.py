"""EmbeddingBag (kernel 9): the hand-written kernel for CUDA tensors,
``embedding_bag_ref`` for CPU tensors (see ``ops``)."""
from .kernel import embedding_bag_cuda
from .ops import embedding_bag
from .ref import embedding_bag_ref

__all__ = ["embedding_bag", "embedding_bag_cuda", "embedding_bag_ref"]
