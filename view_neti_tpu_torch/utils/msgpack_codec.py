"""msgpack reading and writing for checkpoint trees, without the msgpack
package (the machine with the card has neither it nor flax).

It covers what `flax.serialization.msgpack_serialize` writes and
`msgpack_restore` reads for the trees of checkpoint.py: maps, strings,
integers, floats, booleans, nil, lists, binary, and flax's two extension
types, a numpy array (code 1) and a numpy scalar (code 3), each a nested
msgpack array [shape, dtype name, C-order bytes]. (flax splits arrays over
2^30 bytes into chunks; checkpoint trees hold no such array, and the codec
raises on one.) `packb` chooses every encoding as the
msgpack package does (the shortest form; strings as str8 and up; floats as
float64) and sorts map keys as flax's tree traversal does, so it writes the
bytes flax would write for the same tree.
"""
from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2 ** 30


class MsgpackError(ValueError):
    pass


# ---------------------------------------------------------------- pack ----

def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise MsgpackError(f"integer {v} does not fit in 64 bits")
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if v >= low:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise MsgpackError(f"integer {v} does not fit in 64 bits")


def _pack_len(n: int, fix: int, fix_max: int, codes, out: bytearray) -> None:
    """A length header: the fix form below fix_max, else the 8/16/32-bit
    forms in `codes` (None where the type has no such form)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise MsgpackError(f"length {n} too large")


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_len(len(data), None, 0, (0xC7, 0xC8, 0xC9), out)
    out.append(code)
    out += data


def _array_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise MsgpackError("object and structured dtypes are not supported")
    return packb([list(arr.shape), arr.dtype.name,
                  np.ascontiguousarray(arr).tobytes()])


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif type(obj) is int:
        _pack_int(obj, out)
    elif type(obj) is float:
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif type(obj) is str:
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out += data
    elif type(obj) in (bytes, bytearray):
        _pack_len(len(obj), None, 0, (0xC4, 0xC5, 0xC6), out)
        out += obj
    elif type(obj) in (list, tuple):
        _pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif type(obj) is dict:
        _pack_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        # flax maps its tree through jax.tree_util first, which sorts keys
        for k in sorted(obj):
            _pack(k, out)
            _pack(obj[k], out)
    elif isinstance(obj, np.ndarray):
        if obj.nbytes > MAX_CHUNK_SIZE:
            raise MsgpackError("arrays over 2^30 bytes are not supported")
        _pack_ext(EXT_NDARRAY, _array_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _array_payload(np.asarray(obj)), out)
    else:
        raise MsgpackError(f"cannot serialize {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """msgpack bytes of a tree of dict/list/str/bytes/int/float/bool/None
    and numpy arrays or scalars."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# -------------------------------------------------------------- unpack ----

class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.d = memoryview(data)
        self.i = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.i + n > len(self.d):
            raise MsgpackError("truncated msgpack data")
        v = self.d[self.i:self.i + n]
        self.i += n
        return v

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.num(">b")
        data = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _array_from_payload(data)
        if code == EXT_NPSCALAR:
            return _array_from_payload(data)[()]
        raise MsgpackError(f"unknown ext type {code}")

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.num(ints[b])
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",
                0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
                0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in lens:
            n = self.num(lens[b])
            if b <= 0xC6:
                return bytes(self.take(n))
            if b >= 0xD9 and b <= 0xDB:
                return self.string(n)
            if b in (0xDC, 0xDD):
                return [self.value() for _ in range(n)]
            if b in (0xDE, 0xDF):
                return self.map(n)
            return self.ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise MsgpackError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _array_from_payload(data: bytes) -> np.ndarray:
    r = _Reader(data, raw=True)
    shape, name, buf = r.value()
    arr = np.frombuffer(buf, dtype=np.dtype(name.decode()))
    return arr.reshape(shape).copy()


def unpackb(data: bytes) -> Any:
    """The tree of msgpack bytes written by packb or by flax."""
    r = _Reader(data)
    value = r.value()
    if r.i != len(r.d):
        raise MsgpackError("extra bytes after the msgpack object")
    return value
