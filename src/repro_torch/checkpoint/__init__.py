"""Crash-safe checkpoints in the reference's format (``ckpt``) and the
MessagePack codec of their manifests (``msgpack_codec``)."""
from . import ckpt, msgpack_codec

__all__ = ["ckpt", "msgpack_codec"]
