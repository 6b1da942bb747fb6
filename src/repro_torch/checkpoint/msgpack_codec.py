"""A small MessagePack codec for checkpoint manifests.

The manifest is MessagePack, as the reference writes it with
``msgpack.packb``; the machines the port runs on need not have that
package, so this module carries the subset a manifest uses: None, bool,
int (up to 64 bits), float, str, list and tuple (as arrays) and dict (as
maps).  ``packb`` writes exactly the bytes ``msgpack.packb``
writes with its defaults (``use_bin_type=True``, floats as float64, the
smallest int, str, array and map encodings); ``unpackb`` reads what
``msgpack.packb`` writes (maps as dicts, arrays as lists, str as str).
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple


class MsgpackError(ValueError):
    """Bytes that are not a MessagePack value of the supported subset."""


def _pack_int(v: int, out: List[bytes]) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(struct.pack("B", v))
        elif v < 0x100:
            out.append(struct.pack(">BB", 0xCC, v))
        elif v < 0x10000:
            out.append(struct.pack(">BH", 0xCD, v))
        elif v < 0x100000000:
            out.append(struct.pack(">BI", 0xCE, v))
        elif v < 0x10000000000000000:
            out.append(struct.pack(">BQ", 0xCF, v))
        else:
            raise OverflowError("int too big to pack")
    elif v >= -0x20:
        out.append(struct.pack("b", v))
    elif v >= -0x80:
        out.append(struct.pack(">Bb", 0xD0, v))
    elif v >= -0x8000:
        out.append(struct.pack(">Bh", 0xD1, v))
    elif v >= -0x80000000:
        out.append(struct.pack(">Bi", 0xD2, v))
    elif v >= -0x8000000000000000:
        out.append(struct.pack(">Bq", 0xD3, v))
    else:
        raise OverflowError("int too big to pack")


def _pack_len(n: int, fix_base: int, fix_max: int, codes: Tuple[int, ...],
              out: List[bytes]) -> None:
    """A length header: the fix form below ``fix_max``, else the 8 (where
    the type has one), 16 or 32-bit form of ``codes``."""
    if n < fix_max:
        out.append(struct.pack("B", fix_base | n))
        return
    for code, fmt, limit in zip(codes, (">BB", ">BH", ">BI")[-len(codes):],
                                (0x100, 0x10000, 0x100000000)[-len(codes):]):
        if n < limit:
            out.append(struct.pack(fmt, code, n))
            return
    raise ValueError("object too large to pack")


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (0xDC, 0xDD), out)
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``obj`` as MessagePack bytes, byte-equal to ``msgpack.packb(obj)``."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCB: ">d"}
#: code -> (length format, kind) of the sized str, array and map forms
_SIZED = {0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
          0xDC: (">H", "array"), 0xDD: (">I", "array"),
          0xDE: (">H", "map"), 0xDF: (">I", "map")}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.at = 0

    def take(self, n: int) -> memoryview:
        if self.at + n > len(self.data):
            raise MsgpackError("truncated MessagePack data")
        out = self.data[self.at:self.at + n]
        self.at += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self, depth: int = 0) -> Any:
        if depth > 512:
            raise MsgpackError("MessagePack data nested too deep")
        code = self.unpack("B")
        if code < 0x80:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0x80 <= code <= 0x8F:
            return self.sized("map", code & 0x0F, depth)
        if 0x90 <= code <= 0x9F:
            return self.sized("array", code & 0x0F, depth)
        if 0xA0 <= code <= 0xBF:
            return self.sized("str", code & 0x1F, depth)
        if code == 0xC0:
            return None
        if code in (0xC2, 0xC3):
            return code == 0xC3
        if code in _FIXED:
            return self.unpack(_FIXED[code])
        if code in _SIZED:
            fmt, kind = _SIZED[code]
            return self.sized(kind, self.unpack(fmt), depth)
        raise MsgpackError(f"unsupported MessagePack type byte 0x{code:02x}")

    def sized(self, kind: str, n: int, depth: int) -> Any:
        if kind == "str":
            try:
                return bytes(self.take(n)).decode("utf-8")
            except UnicodeDecodeError as e:
                raise MsgpackError(f"invalid utf-8 in a str: {e}") from e
        if kind == "array":
            return [self.value(depth + 1) for _ in range(n)]
        out = {}
        for _ in range(n):
            key = self.value(depth + 1)
            if not isinstance(key, str):
                raise MsgpackError(f"map key of type {type(key).__name__} "
                                   "(only str keys are read)")
            out[key] = self.value(depth + 1)
        return out


def unpackb(data: bytes) -> Any:
    """The value MessagePack ``data`` holds; raises :class:`MsgpackError`
    on malformed, truncated or trailing bytes."""
    r = _Reader(bytes(data))
    obj = r.value()
    if r.at != len(r.data):
        raise MsgpackError(f"{len(r.data) - r.at} bytes of extra data "
                           "after the value")
    return obj
