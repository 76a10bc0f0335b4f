"""The subset of MessagePack (https://msgpack.org/) that the exporters write
and read, so that the port needs no msgpack package.

`packb` gives the bytes of `msgpack.packb(obj)` with that package's defaults
(`use_bin_type=True`, doubles for floats) for dict (map), str, bytes (bin),
int (the smallest encoding: positive values unsigned, negative ones signed),
float (float64), list and tuple (array), bool and None. `unpackb` reads what
`msgpack.packb` writes for those types (plus float32, which it never
writes for a Python float), as `msgpack.unpackb(data, raw=False)` does:
str as str, bin as bytes, arrays as lists.
"""
from __future__ import annotations

import struct


def _head(n: int, fix: int, fix_limit: int, codes) -> bytes:
    """A length header: the fix form below `fix_limit`, else the first of
    `codes` ((code, struct format, limit), ...) whose limit the length
    stays under."""
    if n < fix_limit:
        return bytes((fix | n,))
    for code, fmt, limit in codes:
        if n < limit:
            return bytes((code,)) + struct.pack(fmt, n)
    raise ValueError(f"length {n} too large for msgpack")


_STR = ((0xd9, ">B", 1 << 8), (0xda, ">H", 1 << 16), (0xdb, ">I", 1 << 32))
_BIN = ((0xc4, ">B", 1 << 8), (0xc5, ">H", 1 << 16), (0xc6, ">I", 1 << 32))
_ARRAY = ((0xdc, ">H", 1 << 16), (0xdd, ">I", 1 << 32))
_MAP = ((0xde, ">H", 1 << 16), (0xdf, ">I", 1 << 32))


def _pack_int(v: int) -> bytes:
    if 0 <= v < 128:
        return bytes((v,))
    if -32 <= v < 0:
        return bytes((v & 0xff,))
    if v >= 0:
        for code, fmt, limit in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                                 (0xce, ">I", 1 << 32),
                                 (0xcf, ">Q", 1 << 64)):
            if v < limit:
                return bytes((code,)) + struct.pack(fmt, v)
    else:
        for code, fmt, limit in ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15),
                                 (0xd2, ">i", 1 << 31),
                                 (0xd3, ">q", 1 << 63)):
            if v >= -limit:
                return bytes((code,)) + struct.pack(fmt, v)
    raise OverflowError(f"integer {v} does not fit in 64 bits")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int) and not isinstance(obj, bool):
        out.append(_pack_int(int(obj)))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out.append(_head(len(data), 0xa0, 32, _STR))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        out.append(_head(len(data), 0, 0, _BIN))
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        out.append(_head(len(obj), 0x90, 16, _ARRAY))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        out.append(_head(len(obj), 0x80, 16, _MAP))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """MessagePack bytes of `obj`, equal to msgpack.packb(obj)."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


# Fixed-size codes: (struct format, size).
_FIXED = {0xca: (">f", 4), 0xcb: (">d", 8),
          0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
          0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8)}
# Length-prefixed codes: (kind, struct format of the length, its size).
_SIZED = {0xd9: ("str", ">B", 1), 0xda: ("str", ">H", 2),
          0xdb: ("str", ">I", 4), 0xc4: ("bin", ">B", 1),
          0xc5: ("bin", ">H", 2), 0xc6: ("bin", ">I", 4),
          0xdc: ("array", ">H", 2), 0xdd: ("array", ">I", 4),
          0xde: ("map", ">H", 2), 0xdf: ("map", ">I", 4)}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self):
        code = self.take(1)[0]
        if code <= 0x7f:
            return code
        if code >= 0xe0:
            return code - 0x100
        if code == 0xc0:
            return None
        if code in (0xc2, 0xc3):
            return code == 0xc3
        if code in _FIXED:
            fmt, size = _FIXED[code]
            return struct.unpack(fmt, self.take(size))[0]
        if 0xa0 <= code <= 0xbf:
            kind, n = "str", code & 0x1f
        elif 0x90 <= code <= 0x9f:
            kind, n = "array", code & 0x0f
        elif 0x80 <= code <= 0x8f:
            kind, n = "map", code & 0x0f
        elif code in _SIZED:
            kind, fmt, size = _SIZED[code]
            n = struct.unpack(fmt, self.take(size))[0]
        else:
            raise ValueError(f"unsupported msgpack type 0x{code:02x}")
        if kind == "str":
            return str(self.take(n), "utf-8")
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "array":
            return [self.unpack() for _ in range(n)]
        result = {}
        for _ in range(n):
            key = self.unpack()
            result[key] = self.unpack()
        return result


def unpackb(data: bytes):
    """The object of one MessagePack document (msgpack.unpackb(data,
    raw=False) for the types above); raises ValueError on trailing bytes,
    truncated data or an unsupported type."""
    reader = _Reader(data)
    obj = reader.unpack()
    if reader.pos != len(reader.data):
        raise ValueError("extra bytes after the msgpack object")
    return obj
