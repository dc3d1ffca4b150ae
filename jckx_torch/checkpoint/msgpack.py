"""A decoder of the msgpack that ``flax.serialization.to_bytes`` writes —
the format of jckx's ``.ckpt`` files (``jckx/checkpoint/checkpoint.py:
134-150``), read with the standard library, numpy and torch only.

It reads every msgpack type (maps, arrays, str, bin, ints, floats, bool,
nil) and flax's extension types (flax 0.12's ``serialization.py``,
``_MsgpackExtType``):

- ``1``, an ndarray: a packed ``(shape, dtype name, C-order bytes)``;
- ``2``, a Python complex: a packed ``(real, imag)``;
- ``3``, a numpy scalar: an ndarray of shape ``()``, returned as its
  scalar (``ar[()]``, as flax does).

An ndarray whose dtype is ``bfloat16`` (numpy has none) becomes a torch
``bfloat16`` tensor: its bytes are read as 16-bit integers and viewed as
bf16, bit for bit. Every other array is a numpy array. Maps that hold the
key ``__msgpack_chunked_array__`` are arrays that flax split into chunks
over ``MAX_CHUNK_SIZE`` bytes: their chunks are concatenated and reshaped,
as ``_unchunk`` does.

Anything else (an unknown extension code or dtype, a truncated buffer,
trailing bytes) raises ``ValueError`` naming the source and the path in
the tree.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"
_DTYPES = {name: np.dtype(name) for name in (
    "bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
    "float16", "float32", "float64", "complex64", "complex128")}
_FIXED = {  # lead byte → (struct format, size) of the scalar after it
    0xca: (">f", 4), 0xcb: (">d", 8),
    0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
    0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8),
}


class _Reader:
    def __init__(self, buf: bytes, source: str):
        self.buf = memoryview(buf)
        self.pos = 0
        self.source = source

    def fail(self, path: Tuple, msg: str) -> ValueError:
        where = "/".join(str(p) for p in path) or "<root>"
        return ValueError(f"{self.source}: {msg} at {where}")

    def take(self, n: int, path: Tuple) -> memoryview:
        if self.pos + n > len(self.buf):
            raise self.fail(path, f"truncated msgpack (needs {n} bytes at offset {self.pos}, "
                                  f"{len(self.buf) - self.pos} left)")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str, n: int, path: Tuple):
        return struct.unpack(fmt, self.take(n, path))[0]

    def value(self, path: Tuple) -> Any:
        b = self.unpack(">B", 1, path)
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f, path)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f, path)
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f, path)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXED:
            return self.unpack(*_FIXED[b], path)
        if b in (0xc4, 0xc5, 0xc6):  # bin 8 / 16 / 32
            n = self.unpack(*((">B", 1), (">H", 2), (">I", 4))[b - 0xc4], path)
            return bytes(self.take(n, path))
        if b in (0xd9, 0xda, 0xdb):  # str 8 / 16 / 32
            return self.str(self.unpack(*((">B", 1), (">H", 2), (">I", 4))[b - 0xd9], path), path)
        if b in (0xdc, 0xdd):  # array 16 / 32
            return self.array(self.unpack(*((">H", 2), (">I", 4))[b - 0xdc], path), path)
        if b in (0xde, 0xdf):  # map 16 / 32
            return self.map(self.unpack(*((">H", 2), (">I", 4))[b - 0xde], path), path)
        if 0xd4 <= b <= 0xd8:  # fixext 1 / 2 / 4 / 8 / 16
            return self.ext(1 << (b - 0xd4), path)
        if b in (0xc7, 0xc8, 0xc9):  # ext 8 / 16 / 32
            return self.ext(self.unpack(*((">B", 1), (">H", 2), (">I", 4))[b - 0xc7], path), path)
        raise self.fail(path, f"byte 0x{b:02x} is not a msgpack type")

    def str(self, n: int, path: Tuple) -> str:
        try:
            return bytes(self.take(n, path)).decode("utf-8")
        except UnicodeDecodeError as e:
            raise self.fail(path, f"a str that is not UTF-8 ({e})") from None

    def array(self, n: int, path: Tuple) -> list:
        return [self.value(path + (i,)) for i in range(n)]

    def map(self, n: int, path: Tuple) -> Any:
        out = {}
        for _ in range(n):
            key = self.value(path + ("<key>",))
            if isinstance(key, (list, dict)):
                raise self.fail(path, f"an unhashable map key {key!r}")
            out[key] = self.value(path + (key,))
        if CHUNKED in out:
            return _unchunk(out, self, path)
        return out

    def ext(self, n: int, path: Tuple) -> Any:
        code = self.unpack(">b", 1, path)
        data = bytes(self.take(n, path))
        if code == EXT_COMPLEX:
            real, imag = _decode(data, self.source, path, "a complex")
            return complex(real, imag)
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            arr = _ndarray(data, self, path)
            return arr[()] if code == EXT_NPSCALAR and isinstance(arr, np.ndarray) else arr
        raise self.fail(path, f"unknown msgpack extension type {code} (flax writes 1, 2 and 3)")


def _decode(data: bytes, source: str, path: Tuple, what: str) -> Any:
    r = _Reader(data, f"{source} ({what} at {'/'.join(str(p) for p in path) or '<root>'})")
    out = r.value(())
    if r.pos != len(data):
        raise r.fail((), f"{len(data) - r.pos} trailing bytes")
    return out


def _ndarray(data: bytes, reader: _Reader, path: Tuple):
    """flax's ``_ndarray_from_bytes``: ``(shape, dtype name, C bytes)``."""
    tpl = _decode(data, reader.source, path, "an ndarray")
    if not (isinstance(tpl, list) and len(tpl) == 3 and isinstance(tpl[0], list)):
        raise reader.fail(path, "an ndarray extension that is not (shape, dtype, bytes)")
    shape, name, buf = tpl
    name = name.decode() if isinstance(name, bytes) else name
    bf16 = name == "bfloat16"
    if not bf16 and name not in _DTYPES:
        raise reader.fail(path, f"unknown array dtype {name!r}")
    dtype = np.dtype(np.int16) if bf16 else _DTYPES[name]
    if len(buf) % dtype.itemsize:
        raise reader.fail(path, f"{len(buf)} bytes do not hold whole {name} elements")
    arr = np.frombuffer(buf, dtype=dtype).copy()
    if arr.size != int(np.prod(shape, dtype=np.int64)):
        raise reader.fail(path, f"{arr.size} elements do not fill the shape {tuple(shape)}")
    if bf16:
        return torch.from_numpy(arr).view(torch.bfloat16).reshape(shape)
    return arr.reshape(shape)


def _unchunk(d: dict, reader: _Reader, path: Tuple):
    """flax's ``_unchunk``: ``{"shape": {"0": ...}, "chunks": {"0": ...}}``."""
    try:
        shape = [d["shape"][str(i)] for i in range(len(d["shape"]))]
        chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    except (KeyError, TypeError) as e:
        raise reader.fail(path, f"a malformed chunked array ({e!r})") from None
    if chunks and isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def unpackb(buf: bytes, source: str = "<bytes>") -> Any:
    """The tree of one msgpack document, as ``flax.serialization.
    msgpack_restore`` gives it; ``source`` names the input in errors."""
    r = _Reader(buf, source)
    out = r.value(())
    if r.pos != len(r.buf):
        raise r.fail((), f"{len(r.buf) - r.pos} trailing bytes after the document")
    return out
