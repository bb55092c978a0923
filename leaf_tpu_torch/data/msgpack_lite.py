"""A msgpack codec for the packed-shard records, in the stdlib.

The packed datasets store each shard as one msgpack document (a list of
``{"audio": bytes, "label": str, "duration": int}`` maps). The port reads
and writes them with this module, so that it needs no ``msgpack``
package.

``unpackb(data)`` decodes as ``msgpack.unpackb(data, raw=False)`` does
and ``packb(obj)`` encodes as ``msgpack.packb(obj)`` does (the bin type
on, the smallest width that holds each value), for this subset:

- nil, bool, every int width (positive and negative fixint, uint8–64,
  int8–64), float32 and float64 (packed as float64);
- fixstr, str8/16/32, decoded strictly as UTF-8 to ``str``;
- bin8/16/32, decoded to ``bytes``;
- fixarray, array16/32 (decoded to ``list``) and fixmap, map16/32
  (decoded to ``dict``; keys must be ``str`` or ``bytes``, as
  msgpack's ``strict_map_key``).

Anything else raises ``ValueError`` naming the type byte: ext types
(0xc7–0xc9, 0xd4–0xd8) and the reserved 0xc1. A map that carries
``msgpack_numpy``'s array marker (``b"nd"``, ``b"type"``, ``b"data"``)
raises too: the port does not decode numpy arrays from shards. Truncated
input and trailing bytes raise ``ValueError``; a partial document is
never returned.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

__all__ = ["packb", "unpackb"]

_NUMPY_MARKER = frozenset((b"nd", b"type", b"data"))


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(f"msgpack: truncated input (needs {n} bytes at "
                             f"offset {self.pos}, {len(self.data)} in all)")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# (struct format of the length or value) for each sized type byte
_UINTS = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q"}
_INTS = {0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_STRS = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}
_BINS = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}
_ARRAYS = {0xdc: ">H", 0xdd: ">I"}
_MAPS = {0xde: ">H", 0xdf: ">I"}


def _str(r: _Reader, n: int) -> str:
    return bytes(r.take(n)).decode("utf-8")   # strict: raises on bad UTF-8


def _array(r: _Reader, n: int) -> List[Any]:
    return [_decode(r) for _ in range(n)]


def _map(r: _Reader, n: int, at: int) -> dict:
    out = {}
    for _ in range(n):
        key = _decode(r)
        if not isinstance(key, (str, bytes)):
            raise ValueError(f"msgpack: a map key of type "
                             f"{type(key).__name__} at offset {at} (only str "
                             f"or bytes keys are accepted)")
        out[key] = _decode(r)
    if _NUMPY_MARKER <= out.keys():
        raise ValueError(f"msgpack: the map at offset {at} is a "
                         f"msgpack_numpy array, which this codec does not "
                         f"decode")
    return out


def _decode(r: _Reader) -> Any:
    at = r.pos
    b = r.take(1)[0]
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0xa0 <= b <= 0xbf:
        return _str(r, b & 0x1f)
    if 0x90 <= b <= 0x9f:
        return _array(r, b & 0x0f)
    if 0x80 <= b <= 0x8f:
        return _map(r, b & 0x0f, at)
    if b == 0xc0:
        return None
    if b == 0xc2:
        return False
    if b == 0xc3:
        return True
    if b in _UINTS:
        return r.unpack(_UINTS[b])
    if b in _INTS:
        return r.unpack(_INTS[b])
    if b == 0xca:
        return r.unpack(">f")
    if b == 0xcb:
        return r.unpack(">d")
    if b in _STRS:
        return _str(r, r.unpack(_STRS[b]))
    if b in _BINS:
        return bytes(r.take(r.unpack(_BINS[b])))
    if b in _ARRAYS:
        return _array(r, r.unpack(_ARRAYS[b]))
    if b in _MAPS:
        return _map(r, r.unpack(_MAPS[b]), at)
    raise ValueError(f"msgpack: type byte 0x{b:02x} at offset {at} is "
                     f"outside this codec's subset (ext types and 0xc1 are "
                     f"not decoded)")


def unpackb(data: bytes) -> Any:
    """One msgpack document → Python objects; see the module docstring."""
    r = _Reader(data)
    out = _decode(r)
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} trailing bytes "
                         f"after the document")
    return out


def _sized(n: int, small: Tuple[int, int], widths, what: str) -> bytes:
    """The header of a str/bin/array/map of length n: the fix form where
    ``small`` = (limit, base) allows it, else the narrowest of
    ``widths`` ((type byte, struct format, limit), ...)."""
    limit, base = small
    if n < limit:
        return bytes((base | n,))
    for byte, fmt, top in widths:
        if n <= top:
            return bytes((byte,)) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: a {what} of length {n} is too long")


_W8, _W16, _W32 = 0xff, 0xffff, 0xffffffff


def _encode(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_sized(len(raw), (32, 0xa0), ((0xd9, ">B", _W8),
                                                 (0xda, ">H", _W16),
                                                 (0xdb, ">I", _W32)), "str"))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        out.append(_sized(len(raw), (0, 0), ((0xc4, ">B", _W8),
                                             (0xc5, ">H", _W16),
                                             (0xc6, ">I", _W32)), "bin"))
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        out.append(_sized(len(obj), (16, 0x90), ((0xdc, ">H", _W16),
                                                 (0xdd, ">I", _W32)),
                          "array"))
        for item in obj:
            _encode(item, out)
    elif isinstance(obj, dict):
        out.append(_sized(len(obj), (16, 0x80), ((0xde, ">H", _W16),
                                                 (0xdf, ">I", _W32)), "map"))
        for key, value in obj.items():
            _encode(key, out)
            _encode(value, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def _int(x: int) -> bytes:
    if -32 <= x <= 0x7f:
        return struct.pack(">b", x) if x < 0 else bytes((x,))
    if x > 0:
        for byte, fmt, top in ((0xcc, ">B", _W8), (0xcd, ">H", _W16),
                               (0xce, ">I", _W32),
                               (0xcf, ">Q", 0xffffffffffffffff)):
            if x <= top:
                return bytes((byte,)) + struct.pack(fmt, x)
    else:
        for byte, fmt, bottom in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                                  (0xd2, ">i", -0x80000000),
                                  (0xd3, ">q", -0x8000000000000000)):
            if x >= bottom:
                return bytes((byte,)) + struct.pack(fmt, x)
    raise OverflowError("Integer value out of range")


def packb(obj: Any) -> bytes:
    """Python objects → one msgpack document, byte for byte what
    ``msgpack.packb(obj)`` writes for the subset."""
    out: List[bytes] = []
    _encode(obj, out)
    return b"".join(out)
