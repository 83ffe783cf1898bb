"""Data types of the engine (port of risingwave_tpu/common/types.py).

Every type has a fixed-width tensor representation; variable-width types
(VARCHAR/BYTEA/JSONB) are dictionary-encoded on the host and appear on
the device as int32 ids. DECIMAL is a scaled int64.

Left out of this slice: the dictionary's durable delta log
(`persist_dict_delta` / `load_dict_log`), which belongs to durable state.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass

import numpy as np
import torch


class DataType(enum.Enum):
    BOOLEAN = "boolean"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    DECIMAL = "decimal"      # int64 mantissa, scale carried in the Field
    DATE = "date"            # int32 days since unix epoch
    TIME = "time"            # int64 microseconds since midnight
    TIMESTAMP = "timestamp"  # int64 microseconds since unix epoch (naive)
    TIMESTAMPTZ = "timestamptz"  # int64 microseconds since unix epoch (UTC)
    INTERVAL = "interval"    # int64 microseconds
    VARCHAR = "varchar"      # int32 dictionary id (host StringDictionary)
    BYTEA = "bytea"          # int32 dictionary id
    JSONB = "jsonb"          # int32 dictionary id
    SERIAL = "serial"        # int64

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(_NP_DTYPE[self])

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPE[self]

    @property
    def is_dict_encoded(self) -> bool:
        return self in (DataType.VARCHAR, DataType.BYTEA, DataType.JSONB)

    @property
    def is_float(self) -> bool:
        return self in (DataType.FLOAT32, DataType.FLOAT64)

    def zero_value(self):
        if self is DataType.BOOLEAN:
            return False
        if self.is_float:
            return 0.0
        return 0


_NP_DTYPE = {
    DataType.BOOLEAN: np.bool_,
    DataType.INT16: np.int16,
    DataType.INT32: np.int32,
    DataType.INT64: np.int64,
    DataType.FLOAT32: np.float32,
    DataType.FLOAT64: np.float64,
    DataType.DECIMAL: np.int64,
    DataType.DATE: np.int32,
    DataType.TIME: np.int64,
    DataType.TIMESTAMP: np.int64,
    DataType.TIMESTAMPTZ: np.int64,
    DataType.INTERVAL: np.int64,
    DataType.VARCHAR: np.int32,
    DataType.BYTEA: np.int32,
    DataType.JSONB: np.int32,
    DataType.SERIAL: np.int64,
}

_TORCH_DTYPE = {
    DataType.BOOLEAN: torch.bool,
    DataType.INT16: torch.int16,
    DataType.INT32: torch.int32,
    DataType.INT64: torch.int64,
    DataType.FLOAT32: torch.float32,
    DataType.FLOAT64: torch.float64,
    DataType.DECIMAL: torch.int64,
    DataType.DATE: torch.int32,
    DataType.TIME: torch.int64,
    DataType.TIMESTAMP: torch.int64,
    DataType.TIMESTAMPTZ: torch.int64,
    DataType.INTERVAL: torch.int64,
    DataType.VARCHAR: torch.int32,
    DataType.BYTEA: torch.int32,
    DataType.JSONB: torch.int32,
    DataType.SERIAL: torch.int64,
}


@dataclass(frozen=True)
class Field:
    """A named, typed column of a schema."""

    name: str
    data_type: DataType
    scale: int = 0  # decimal scale when data_type == DECIMAL


@dataclass(frozen=True)
class Schema:
    fields: tuple[Field, ...]

    def __post_init__(self):
        object.__setattr__(self, "fields", tuple(self.fields))

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __getitem__(self, i: int) -> Field:
        return self.fields[i]

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(f.name for f in self.fields)

    @property
    def data_types(self) -> tuple[DataType, ...]:
        return tuple(f.data_type for f in self.fields)

    def select(self, indices) -> "Schema":
        return Schema(tuple(self.fields[i] for i in indices))


def schema(*pairs) -> Schema:
    """schema(("a", DataType.INT64), ("b", DataType.FLOAT64))"""
    return Schema(tuple(Field(n, t) for n, t in pairs))


class StringDictionary:
    """Host-side append-only string<->id mapping for dict-encoded columns.

    The device only sees int32 ids; equality and group-by on strings are
    exact on ids. Ids of one process's dictionary mean nothing to another
    (the JAX package keeps its own), so cross-package comparisons decode.
    """

    __slots__ = ("_strings", "_ids", "_mint_lock")

    def __init__(self):
        self._strings: list[str] = []
        self._ids: dict[str, int] = {}
        # minting must be atomic across threads; reads stay lock-free
        # because both structures are append-only
        self._mint_lock = threading.Lock()

    def __len__(self):
        return len(self._strings)

    def get_or_insert(self, s: str) -> int:
        i = self._ids.get(s)
        if i is None:
            with self._mint_lock:
                i = self._ids.get(s)
                if i is None:
                    i = len(self._strings)
                    self._strings.append(s)
                    self._ids[s] = i
        return i

    def decode(self, i: int) -> str:
        return self._strings[i]

    def decode_many(self, ids) -> list[str]:
        return [self._strings[int(i)] for i in np.asarray(ids).ravel()]


# Process-global dictionary: ids are consistent across all columns, so
# dict-encoded values flow between operators without re-encoding.
GLOBAL_DICT = StringDictionary()
