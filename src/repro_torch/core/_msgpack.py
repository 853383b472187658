"""The subset of MessagePack that the recording framing uses.

``packb(obj)`` gives the bytes of ``msgpack.packb(obj, use_bin_type=True)``
and ``unpackb(data)`` the objects of ``msgpack.unpackb(data, raw=False)``
for dict, list (and tuple, packed as a list), str, bytes, int, float,
bool and None: ints in the smallest format that holds them (unsigned
formats for non-negative ints), floats as float64, str as UTF-8 in the
str formats, bytes in the bin formats.  The port frames its recordings
with this module instead of the ``msgpack`` package, which the machines
that serve the port need not have; the tests hold it to ``msgpack``.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple

_U8, _U16, _U32, _U64 = (struct.Struct(f">{c}") for c in "BHIQ")
_I8, _I16, _I32, _I64 = (struct.Struct(f">{c}") for c in "bhiq")
_F32, _F64 = struct.Struct(">f"), struct.Struct(">d")


def _head(out: List[bytes], n: int, fix_base: int, fix_max: int,
          codes: Tuple[int, int, int]) -> None:
    """A str/bin/array/map header: the fix form below ``fix_max`` (where
    the type has one), else the 8-, 16- or 32-bit length form."""
    if fix_max and n < fix_max:
        out.append(bytes((fix_base | n,)))
    elif codes[0] and n <= 0xFF:
        out.append(bytes((codes[0], n)))
    elif n <= 0xFFFF:
        out.append(bytes((codes[1],)) + _U16.pack(n))
    elif n <= 0xFFFFFFFF:
        out.append(bytes((codes[2],)) + _U32.pack(n))
    else:
        raise ValueError(f"msgpack: length {n} too large")


def _int(out: List[bytes], x: int) -> None:
    if 0 <= x < 0x80 or -32 <= x < 0:
        out.append(_I8.pack(x) if x < 0 else bytes((x,)))
    elif x >= 0:
        for code, st in ((0xCC, _U8), (0xCD, _U16), (0xCE, _U32),
                         (0xCF, _U64)):
            if x < 1 << (8 * st.size):
                out.append(bytes((code,)) + st.pack(x))
                return
        raise OverflowError(f"msgpack: int {x} too big to pack")
    else:
        for code, st in ((0xD0, _I8), (0xD1, _I16), (0xD2, _I32),
                         (0xD3, _I64)):
            if x >= -(1 << (8 * st.size - 1)):
                out.append(bytes((code,)) + st.pack(x))
                return
        raise OverflowError(f"msgpack: int {x} too small to pack")


def _pack(out: List[bytes], obj: Any) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _int(out, obj)
    elif isinstance(obj, float):
        out.append(b"\xcb" + _F64.pack(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _head(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _head(out, len(raw), 0, 0, (0xC4, 0xC5, 0xC6))
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, (0, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16, (0, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"msgpack: cannot serialize {type(obj).__name__!r}")


def packb(obj: Any) -> bytes:
    out: List[bytes] = []
    _pack(out, obj)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.at = 0

    def take(self, n: int) -> memoryview:
        end = self.at + n
        if end > len(self.data):
            raise ValueError("msgpack: truncated data")
        chunk = self.data[self.at:end]
        self.at = end
        return chunk

    def num(self, st: struct.Struct):
        return st.unpack(self.take(st.size))[0]


_LEN = {0xD9: _U8, 0xDA: _U16, 0xDB: _U32, 0xC4: _U8, 0xC5: _U16,
        0xC6: _U32, 0xDC: _U16, 0xDD: _U32, 0xDE: _U16, 0xDF: _U32}
_NUM = {0xCA: _F32, 0xCB: _F64, 0xCC: _U8, 0xCD: _U16, 0xCE: _U32,
        0xCF: _U64, 0xD0: _I8, 0xD1: _I16, 0xD2: _I32, 0xD3: _I64}


def _unpack(r: _Reader, depth: int) -> Any:
    if depth > 512:
        raise ValueError("msgpack: nesting too deep")
    b = r.num(_U8)
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if b in _NUM:
        return r.num(_NUM[b])
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if 0xA0 <= b <= 0xBF or b in (0xD9, 0xDA, 0xDB):
        n = b & 0x1F if b <= 0xBF else r.num(_LEN[b])
        return str(r.take(n), "utf-8")
    if b in (0xC4, 0xC5, 0xC6):
        return bytes(r.take(r.num(_LEN[b])))
    if 0x90 <= b <= 0x9F or b in (0xDC, 0xDD):
        n = b & 0x0F if b <= 0x9F else r.num(_LEN[b])
        return [_unpack(r, depth + 1) for _ in range(n)]
    if 0x80 <= b <= 0x8F or b in (0xDE, 0xDF):
        n = b & 0x0F if b <= 0x8F else r.num(_LEN[b])
        d = {}
        for _ in range(n):
            k = _unpack(r, depth + 1)
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"msgpack: {type(k).__name__} is not "
                                 "allowed for map key")
            d[k] = _unpack(r, depth + 1)
        return d
    raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")


def unpackb(data: bytes) -> Any:
    r = _Reader(data)
    obj = _unpack(r, 0)
    if r.at != len(r.data):
        raise ValueError("msgpack: extra data after the object")
    return obj
