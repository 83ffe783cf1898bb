"""Row serde: memcomparable key encoding + value encoding
(port of risingwave_tpu/state/serde.py).

Reference: src/common/src/util/memcmp_encoding.rs and util/value_encoding/ —
primary keys are serialized so that byte order == row order (LSM range scans
give pk order for free), values are a compact fixed-layout encoding.

Subset choices: all device types are fixed-width ints/
floats (types.py), so encoding is per-field:
  null flag byte (0x00 null / 0x01 value, nulls-first like the reference
  default) ++ order-preserving bytes:
    signed int  -> big-endian with sign bit flipped
    float       -> big-endian IEEE; if negative flip all bits else flip sign
    bool        -> single byte
    dict ids    -> int32 rule (NOTE: id order, not lexicographic string
                   order — ordered ops on strings take the host path)
Descending order flips all bytes (used by TopN/OverWindow orderings).
"""

from __future__ import annotations

import struct
from typing import Optional, Sequence

from ..common.types import DataType, Schema

_INT_WIDTH = {
    DataType.INT16: 2, DataType.DATE: 4, DataType.INT32: 4,
    DataType.VARCHAR: 4, DataType.BYTEA: 4, DataType.JSONB: 4,
    DataType.INT64: 8, DataType.TIME: 8, DataType.TIMESTAMP: 8,
    DataType.TIMESTAMPTZ: 8, DataType.INTERVAL: 8, DataType.DECIMAL: 8,
    DataType.SERIAL: 8,
}


def _enc_int(v: int, width: int) -> bytes:
    bias = 1 << (8 * width - 1)
    return (int(v) + bias).to_bytes(width, "big")


def _dec_int(b: bytes) -> int:
    bias = 1 << (8 * len(b) - 1)
    return int.from_bytes(b, "big") - bias


def _enc_float(v: float, fmt: str) -> bytes:
    raw = struct.pack(">" + fmt, v)
    n = int.from_bytes(raw, "big")
    top = 1 << (8 * len(raw) - 1)
    n = (n ^ ((1 << (8 * len(raw))) - 1)) if (n & top) else (n | top)
    return n.to_bytes(len(raw), "big")


def _dec_float(b: bytes, fmt: str) -> float:
    n = int.from_bytes(b, "big")
    top = 1 << (8 * len(b) - 1)
    n = (n ^ top) if (n & top) else (n ^ ((1 << (8 * len(b))) - 1))
    return struct.unpack(">" + fmt, n.to_bytes(len(b), "big"))[0]


def encode_memcomparable(
    values: Sequence, types: Sequence[DataType], descending: Optional[Sequence[bool]] = None,
) -> bytes:
    out = bytearray()
    for i, (v, t) in enumerate(zip(values, types)):
        desc = bool(descending[i]) if descending is not None else False
        if v is None:
            field = b"\x00"
        else:
            if t is DataType.BOOLEAN:
                body = b"\x01" if v else b"\x00"
            elif t in (DataType.FLOAT32, DataType.FLOAT64):
                body = _enc_float(float(v), "f" if t is DataType.FLOAT32 else "d")
            else:
                body = _enc_int(int(v), _INT_WIDTH[t])
            field = b"\x01" + body
        if desc:
            field = bytes(0xFF - b for b in field)
        out += field
    return bytes(out)


def decode_memcomparable(
    data: bytes, types: Sequence[DataType], descending: Optional[Sequence[bool]] = None,
) -> tuple:
    vals = []
    pos = 0
    for i, t in enumerate(types):
        desc = bool(descending[i]) if descending is not None else False
        if t is DataType.BOOLEAN:
            width = 1
        elif t is DataType.FLOAT32:
            width = 4
        elif t is DataType.FLOAT64:
            width = 8
        else:
            width = _INT_WIDTH[t]
        flag = data[pos]
        if desc:
            flag = 0xFF - flag
        pos += 1
        if flag == 0x00:
            vals.append(None)
            continue
        body = data[pos:pos + width]
        if desc:
            body = bytes(0xFF - b for b in body)
        pos += width
        if t is DataType.BOOLEAN:
            vals.append(body[0] != 0)
        elif t in (DataType.FLOAT32, DataType.FLOAT64):
            vals.append(_dec_float(body, "f" if t is DataType.FLOAT32 else "d"))
        else:
            vals.append(_dec_int(body))
    return tuple(vals)


# ----------------------------------------------------------- value encoding

def _fmt_char(t: DataType) -> str:
    if t is DataType.BOOLEAN:
        return "?"
    if t is DataType.FLOAT32:
        return "f"
    if t is DataType.FLOAT64:
        return "d"
    w = _INT_WIDTH[t]
    return {2: "h", 4: "i", 8: "q"}[w]


class RowSerde:
    """Fixed-layout value encoding with a null bitmap prefix."""

    def __init__(self, schema: Schema):
        self.schema = schema
        self._fmt = "<" + "".join(_fmt_char(f.data_type) for f in schema)
        self._nbytes_nulls = (len(schema) + 7) // 8
        self._zeros = tuple(f.data_type.zero_value() for f in schema)

    def encode(self, values: Sequence) -> bytes:
        nulls = 0
        clean = []
        for i, v in enumerate(values):
            if v is None:
                nulls |= 1 << i
                clean.append(self._zeros[i])
            else:
                clean.append(v)
        return nulls.to_bytes(self._nbytes_nulls, "little") + struct.pack(self._fmt, *clean)

    def decode(self, data: bytes) -> tuple:
        nulls = int.from_bytes(data[: self._nbytes_nulls], "little")
        vals = struct.unpack(self._fmt, data[self._nbytes_nulls:])
        return tuple(None if (nulls >> i) & 1 else v for i, v in enumerate(vals))
