"""The msgpack subset the checkpoint index uses — map, array, str, bin,
int, float, bool, nil — written byte for byte as ``msgpack.packb`` writes
it (smallest int encoding, floats as float64, str8 for short strings), and
read back as ``msgpack.unpackb`` reads it.  The machine with the card has no
``msgpack`` package, and the index must stay readable by the JAX package."""
from __future__ import annotations

import struct


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_len(n: int, fix_base: int, fix_max: int, codes, out) -> None:
    if n <= fix_max and fix_base is not None:
        out.append(fix_base | n)
    elif codes[0] is not None and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out += raw
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), None, -1, (0xC4, 0xC5, 0xC6), out)
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80 or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif v >= 0:
        for code, fmt, lim in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16),
                               (0xCE, ">BI", 1 << 32), (0xCF, ">BQ", 1 << 64)):
            if v < lim:
                out += struct.pack(fmt, code, v)
                return
        raise OverflowError("int too big to pack")
    else:
        for code, fmt, lim in ((0xD0, ">Bb", 1 << 7), (0xD1, ">Bh", 1 << 15),
                               (0xD2, ">Bi", 1 << 31), (0xD3, ">Bq", 1 << 63)):
            if v >= -lim:
                out += struct.pack(fmt, code, v)
                return
        raise OverflowError("int too small to pack")


def unpackb(raw: bytes):
    obj, pos = _unpack(memoryview(raw), 0)
    if pos != len(raw):
        raise ValueError(f"extra data after msgpack object ({len(raw) - pos} "
                         "bytes)")
    return obj


_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
          0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LENS = {0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
         0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
         0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
         0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def _unpack(buf: memoryview, pos: int):
    b = buf[pos]
    pos += 1
    if b < 0x80:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if b == 0xC0:
        return None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, pos
    if b in _FIXED:
        fmt = _FIXED[b]
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, buf[pos:pos + size])[0], pos + size
    if 0xA0 <= b <= 0xBF:
        kind, n = "str", b & 0x1F
    elif 0x90 <= b <= 0x9F:
        kind, n = "array", b & 0x0F
    elif 0x80 <= b <= 0x8F:
        kind, n = "map", b & 0x0F
    elif b in _LENS:
        kind, fmt = _LENS[b]
        size = struct.calcsize(fmt)
        n = struct.unpack(fmt, buf[pos:pos + size])[0]
        pos += size
    else:
        raise ValueError(f"msgpack type 0x{b:02x} is outside the subset the "
                         "checkpoint index uses")
    if kind == "str":
        return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n
    if kind == "bin":
        return bytes(buf[pos:pos + n]), pos + n
    if kind == "array":
        items = []
        for _ in range(n):
            v, pos = _unpack(buf, pos)
            items.append(v)
        return items, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        v, pos = _unpack(buf, pos)
        out[k] = v
    return out, pos
