"""The subset of msgpack that flax checkpoints use, read and written without
the ``msgpack`` package.

``flax.serialization.to_bytes`` writes a parameter tree as a msgpack map of
string keys whose leaves are extension objects: type 1 holds an ndarray as
the msgpack of ``(shape, dtype name, C-order bytes)``, type 3 a numpy scalar
the same way. :func:`packb` writes such a tree as flax does, choosing the
smallest encoding of each item as the msgpack package does; :func:`unpackb`
reads it back, with every fixed-size form of the format. flax splits an
array above 2^30 bytes into chunks; such arrays are refused here.
"""

from __future__ import annotations

import struct
from collections.abc import Mapping
from typing import Any

import numpy as np

NDARRAY_EXT = 1
NPSCALAR_EXT = 3
# flax.serialization.MAX_CHUNK_SIZE: flax chunks arrays larger than this
MAX_ARRAY_BYTES = 2 ** 30


def _uint_header(n: int, fix_base: int, fix_max: int, codes) -> bytes:
    """The header of a length-prefixed item: the fixed form up to
    ``fix_max``, else 8, 16 or 32 bits (``codes`` maps each width, or
    omits 8)."""
    if n <= fix_max:
        return bytes([fix_base | n])
    for width, fmt in ((8, ">B"), (16, ">H"), (32, ">I")):
        if width in codes and n < (1 << width):
            return bytes([codes[width]]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} does not fit in 32 bits")


def _pack_int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < top:
                return bytes([code]) + struct.pack(fmt, v)
    for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                           (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
        if v >= low:
            return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"msgpack: integer {v} does not fit in 64 bits")


def _pack_ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        head = bytes([fixed[len(data)]])
    else:
        head = _uint_header(len(data), 0, -1, {8: 0xC7, 16: 0xC8, 32: 0xC9})
    return head + struct.pack(">b", code) + data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("msgpack: object and structured arrays are not supported")
    if arr.nbytes > MAX_ARRAY_BYTES:
        raise ValueError(
            f"msgpack: an array of {arr.nbytes} bytes exceeds {MAX_ARRAY_BYTES}; flax "
            "would split it into chunks, which this reader and writer do not do"
        )
    return packb((tuple(int(d) for d in arr.shape), arr.dtype.name, arr.tobytes("C")))


def packb(obj: Any) -> bytes:
    """Encode ``obj``: mappings with string keys, lists and tuples, str,
    bytes, bool, int, float, None, numpy arrays (extension 1) and numpy
    scalars (extension 3)."""
    if obj is None:
        return b"\xc0"
    if obj is True or obj is False:
        return b"\xc3" if obj else b"\xc2"
    if isinstance(obj, np.ndarray):
        return _pack_ext(NDARRAY_EXT, _ndarray_bytes(obj))
    if isinstance(obj, np.generic):
        return _pack_ext(NPSCALAR_EXT, _ndarray_bytes(np.asarray(obj)))
    if isinstance(obj, int):
        return _pack_int(obj)
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        raw = obj.encode("utf-8")
        return _uint_header(len(raw), 0xA0, 31, {8: 0xD9, 16: 0xDA, 32: 0xDB}) + raw
    if isinstance(obj, (bytes, bytearray)):
        return _uint_header(len(obj), 0, -1, {8: 0xC4, 16: 0xC5, 32: 0xC6}) + bytes(obj)
    if isinstance(obj, (list, tuple)):
        return (_uint_header(len(obj), 0x90, 15, {16: 0xDC, 32: 0xDD})
                + b"".join(packb(v) for v in obj))
    if isinstance(obj, Mapping):
        parts = [_uint_header(len(obj), 0x80, 15, {16: 0xDE, 32: 0xDF})]
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"msgpack: map keys must be str, got {type(k).__name__}")
            parts += [packb(k), packb(v)]
        return b"".join(parts)
    raise TypeError(f"msgpack: cannot encode {type(obj).__name__}")


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        raw = self.take(n)
        return raw if self.raw else raw.decode("utf-8")

    def ext(self, n: int):
        code = self.num(">b")
        data = self.take(n)
        if code not in (NDARRAY_EXT, NPSCALAR_EXT):
            raise ValueError(f"msgpack: extension type {code} is not a flax array")
        shape, dtype_name, buf = _Reader(data, raw=True).item()
        arr = np.frombuffer(buf, dtype=np.dtype(dtype_name.decode())).reshape(shape)
        return arr[()] if code == NPSCALAR_EXT else arr

    def item(self):
        b = self.num(">B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b < 0x90:
            return {self.item(): self.item() for _ in range(b & 0x0F)}
        if b < 0xA0:
            return [self.item() for _ in range(b & 0x0F)]
        if b < 0xC0:
            return self.string(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.num(numbers[b])
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
                 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in sizes:
            n = self.num(sizes[b])
            if b <= 0xC6:
                return self.take(n)
            if b <= 0xC9:
                return self.ext(n)
            if b <= 0xDB:
                return self.string(n)
            if b <= 0xDD:
                return [self.item() for _ in range(n)]
            return {self.item(): self.item() for _ in range(n)}
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")


def unpackb(data: bytes) -> Any:
    """Decode what :func:`packb` or ``flax.serialization.to_bytes`` wrote:
    maps become dicts, arrays lists, extension 1 numpy arrays (read-only
    views of ``data``) and extension 3 numpy scalars."""
    reader = _Reader(data, raw=False)
    out = reader.item()
    if reader.pos != len(reader.data):
        raise ValueError("msgpack: trailing bytes after the first object")
    return out
