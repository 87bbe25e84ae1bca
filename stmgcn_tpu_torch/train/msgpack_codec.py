"""A small msgpack encoder and decoder for checkpoint blobs.

The JAX package writes a checkpoint's params and optimizer blobs with
``flax.serialization.to_bytes`` (``stmgcn_tpu/train/checkpoint.py``): a
msgpack document of string-keyed maps whose leaves are arrays. The port
reads and writes the same bytes without flax or the ``msgpack`` package,
covering exactly the subset those blobs use:

- nil, bool, int, float, str, bin, arrays (lists/tuples) and maps with
  str keys, in msgpack's smallest encodings (as ``msgpack.packb`` with
  ``use_bin_type=True`` writes them), maps in sorted key order (as flax
  writes them), so a tree encodes to flax's very bytes;
- ExtType 1, an ndarray: the packed ``(shape, dtype name, C-order bytes)``;
- ExtType 3, a numpy scalar, packed as a 0-d ndarray.

Flax splits a leaf over 2^30 bytes into ``{"__msgpack_chunked_array__":
...}`` chunks; those are refused by name (the default model's parameters
are 1.15 MB). Decoded arrays are numpy arrays over their own copy of the
bytes.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["CHUNKED_KEY", "packb", "unpackb"]

#: the map key flax gives a chunked oversized leaf
CHUNKED_KEY = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
#: flax chunks a leaf of more bytes (``flax.serialization.MAX_CHUNK_SIZE``)
_MAX_LEAF_BYTES = 2 ** 30


def _sized(out: bytearray, n: int, fix_base, fix_limit: int, codes) -> None:
    """A length header: the fix form below ``fix_limit`` (when there is
    one), else the first of 8/16/32-bit ``codes`` that holds ``n``."""
    if fix_base is not None and n < fix_limit:
        out.append(fix_base | n)
        return
    for code, fmt in zip(codes, (">B", ">H", ">I")):
        if code is not None and n < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} does not fit 32 bits")


def _int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")):
            if v < 1 << (8 * struct.calcsize(fmt)):
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"msgpack: integer {v} does not fit 64 bits")
    else:
        for code, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q")):
            if v >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"msgpack: integer {v} does not fit 64 bits")


def _ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _sized(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError(f"msgpack: cannot encode an array of dtype {arr.dtype}")
    if arr.nbytes > _MAX_LEAF_BYTES:
        raise ValueError(
            f"msgpack: a {arr.nbytes}-byte leaf would be written as flax's "
            f"{CHUNKED_KEY!r} chunks, which this codec does not take")
    return packb((tuple(int(d) for d in arr.shape), arr.dtype.name,
                  np.ascontiguousarray(arr).tobytes()))


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, np.ndarray):
        _ext(out, _EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):
        _ext(out, _EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    elif isinstance(obj, int):
        _int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _sized(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _sized(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _sized(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        if CHUNKED_KEY in obj:
            raise ValueError(f"msgpack: {CHUNKED_KEY!r} leaves are not supported")
        if not all(isinstance(key, str) for key in obj):
            raise TypeError(f"msgpack: map keys must be str, got {list(obj)!r}")
        _sized(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for key in sorted(obj):  # flax's trees pass through jax, which sorts keys
            _pack(out, key)
            _pack(out, obj[key])
    else:
        raise TypeError(f"msgpack: cannot encode {type(obj).__name__}")


def packb(obj) -> bytes:
    """``obj`` as msgpack bytes (numpy arrays and scalars as flax's
    ExtTypes 1 and 3)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated document (wanted {n} bytes at "
                             f"offset {self.pos} of {len(self.data)})")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        code = self.unpack(">B")
        if code <= 0x7F:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0x80 <= code <= 0x8F:
            return self.map(code & 0x0F)
        if 0x90 <= code <= 0x9F:
            return self.array(code & 0x0F)
        if 0xA0 <= code <= 0xBF:
            return self.str(code & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if code in simple:
            return simple[code]
        sized = {0xC4: (">B", self.bin), 0xC5: (">H", self.bin), 0xC6: (">I", self.bin),
                 0xC7: (">B", self.ext), 0xC8: (">H", self.ext), 0xC9: (">I", self.ext),
                 0xD9: (">B", self.str), 0xDA: (">H", self.str), 0xDB: (">I", self.str),
                 0xDC: (">H", self.array), 0xDD: (">I", self.array),
                 0xDE: (">H", self.map), 0xDF: (">I", self.map)}
        if code in sized:
            fmt, read = sized[code]
            return read(self.unpack(fmt))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if code in numbers:
            return self.unpack(numbers[code])
        if 0xD4 <= code <= 0xD8:
            return self.ext(1 << (code - 0xD4))
        raise ValueError(f"msgpack: unknown type byte {code:#04x} at offset {self.pos - 1}")

    def bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            if not isinstance(key, str):
                raise ValueError(f"msgpack: map key {key!r} is not a str")
            out[key] = self.read()
        if CHUNKED_KEY in out:
            raise ValueError(f"msgpack: {CHUNKED_KEY!r} leaves are not supported")
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack: ExtType {code} is not supported")
        shape, dtype, buf = unpackb(data)
        if not isinstance(buf, bytes) or not isinstance(dtype, str):
            raise ValueError("msgpack: malformed ndarray ExtType")
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()
        return arr[()] if code == _EXT_NPSCALAR else arr


def unpackb(data: bytes):
    """The object ``data`` encodes; raises ``ValueError`` on a truncated or
    malformed document, trailing bytes, or a type outside the subset."""
    reader = _Reader(data)
    obj = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} trailing bytes")
    return obj
