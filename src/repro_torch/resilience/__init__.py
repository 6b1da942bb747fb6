"""Admission guard of the serving path (``guard.validate_batch``)."""
from .guard import QuarantinedBatch, validate_batch

__all__ = ["QuarantinedBatch", "validate_batch"]
