"""A small MessagePack encoder and decoder for the checkpoint format.

The card's machine has no `msgpack` package, so the port carries the
subset of the format its checkpoints use: maps, strings, binary (bin 8,
16 and 32), arrays, integers, float64, nil and booleans. `packb(obj)`
gives the bytes of `msgpack.packb(obj, use_bin_type=True)` (the smallest
encoding of each value, as that packer picks it); `unpackb` also reads
float32, which that packer never writes. Binary values decode as
memoryviews into the buffer given (no copy of a tensor's bytes).
"""
from __future__ import annotations

import struct


def _size_head(n: int, fix_base: int, fix_max: int, codes) -> bytes:
    """The head of a str / bin / array / map of `n` items: a fix form
    below `fix_max` (when the type has one), else the 8, 16 or 32-bit
    length form of `codes`."""
    if fix_base is not None and n < fix_max:
        return bytes((fix_base | n,))
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (0x100, 0x10000, 0x100000000)):
        if code is not None and n < limit:
            return bytes((code,)) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: {n} items is too many")


def _pack_int(x: int) -> bytes:
    if -32 <= x < 128:
        return struct.pack(">b", x) if x < 0 else bytes((x,))
    if x > 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32),
                                 (0xCF, ">Q", 1 << 64)):
            if x < limit:
                return bytes((code,)) + struct.pack(fmt, x)
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31),
                                 (0xD3, ">q", 1 << 63)):
            if x >= -limit:
                return bytes((code,)) + struct.pack(fmt, x)
    raise OverflowError(f"msgpack: integer {x} out of range")


def pack_into(obj, out: list) -> None:
    """Append the encoding of `obj` to `out` as pieces (bytes and
    bytes-like views), so large binary values are never copied here."""
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out.append(_size_head(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB)))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = memoryview(obj).nbytes
        out.append(_size_head(n, None, 0, (0xC4, 0xC5, 0xC6)))
        out.append(obj)
    elif isinstance(obj, dict):
        out.append(_size_head(len(obj), 0x80, 16, (None, 0xDE, 0xDF)))
        for k, v in obj.items():
            pack_into(k, out)
            pack_into(v, out)
    elif isinstance(obj, (list, tuple)):
        out.append(_size_head(len(obj), 0x90, 16, (None, 0xDC, 0xDD)))
        for v in obj:
            pack_into(v, out)
    else:
        raise TypeError(f"msgpack: cannot encode {type(obj).__name__}")


def packb(obj) -> bytes:
    """`msgpack.packb(obj, use_bin_type=True)`'s bytes."""
    out: list = []
    pack_into(obj, out)
    return b"".join(out)


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
          0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_LENGTH = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xC4: ">B", 0xC5: ">H",
           0xC6: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated data")
        view = self.buf[self.pos: self.pos + n]
        self.pos += n
        return view

    def fixed(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b < 0x90:
            return self.map(b & 0x0F)
        if b < 0xA0:
            return [self.value() for _ in range(b & 0x0F)]
        if b < 0xC0:
            return str(self.take(b & 0x1F), "utf-8")
        if b in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[b]
        if b in _FIXED:
            return self.fixed(_FIXED[b])
        if b not in _LENGTH:
            raise ValueError(f"msgpack: unsupported type byte {b:#x}")
        n = self.fixed(_LENGTH[b])
        if b in (0xD9, 0xDA, 0xDB):
            return str(self.take(n), "utf-8")
        if b in (0xC4, 0xC5, 0xC6):
            return self.take(n)
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(n)]
        return self.map(n)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def unpackb(buf):
    """Decode one msgpack value from `buf` (bytes-like); binary values
    come back as memoryviews into `buf`."""
    r = _Reader(buf)
    obj = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} bytes after the "
                         "value")
    return obj
