"""TPC-H datagen connector — deterministic, seekable part/lineitem streams
for the q17 workload (port of risingwave_tpu/connectors/tpch.py).

Rows are a pure function of the row offset: a counter-based splitmix64
(the Nexmark generators' scheme), so a chunk is generated on the device,
seekable for exactly-once replay, and bit-identical to the JAX package
for the same start offset. A fixed universe of NUM_PARTS part keys that
lineitems draw from uniformly; brand and container derive from the
part key's hash, so any prefix of both streams agrees with a host
recount; prices are integers.

Both tables are kernel K13 (`csrc/tpch.cu`) on a CUDA device; the plain
PyTorch version runs on the CPU. Brand and container are int64
dictionary ids (as the reference emits them), minted in the port's
GLOBAL_DICT: their numbers differ from the JAX package's, their strings
do not.
"""

from __future__ import annotations

import ctypes

import torch

from ..common.chunk import Column, StreamChunk
from ..common.types import DataType, GLOBAL_DICT, schema
from ..device import resolve_device
from ..ops import kernels
from ..ops.hashing import splitmix64, umod

NUM_PARTS = 1000
BRANDS = [f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)]
CONTAINERS = [f"{s} {t}" for s in ("SM", "MED", "LG", "JUMBO")
              for t in ("CASE", "BOX", "PACK", "DRUM")]

PART_SCHEMA = schema(
    ("p_partkey", DataType.INT64),
    ("p_brand", DataType.VARCHAR),
    ("p_container", DataType.VARCHAR),
    ("p_retailprice", DataType.INT64),
)

LINEITEM_SCHEMA = schema(
    ("l_orderkey", DataType.INT64),
    ("l_partkey", DataType.INT64),
    ("l_quantity", DataType.INT64),
    ("l_extendedprice", DataType.INT64),
)

TPCH_SCHEMAS = {"part": PART_SCHEMA, "lineitem": LINEITEM_SCHEMA}
_TABLE_CODES = {"part": 0, "lineitem": 1}


def vocab_ids() -> dict[str, tuple[int, ...]]:
    """Dictionary ids of the brand and container vocabularies, minted in
    GLOBAL_DICT (ids need not be contiguous: a string may already be in
    the dictionary, from a bound SQL literal say)."""
    return {"tpch_brand": tuple(GLOBAL_DICT.get_or_insert(s)
                                for s in BRANDS),
            "tpch_container": tuple(GLOBAL_DICT.get_or_insert(s)
                                    for s in CONTAINERS)}


def _part_cols(keys: torch.Tensor, brand_ids: torch.Tensor,
               container_ids: torch.Tensor):
    """Brand, container and price of the parts keyed by `keys` (shared by
    both tables, so lineitem prices agree with the part rows)."""
    h = splitmix64(keys ^ 0xA5A5)
    brand = brand_ids[umod(h, len(BRANDS))]
    h2 = splitmix64(keys ^ 0x5A5A)
    container = container_ids[umod(h2, len(CONTAINERS))]
    price = 900 + umod(h, 200)
    return brand, container, price


def gen_tpch_columns_plain(table: str, offset: int, n: int,
                           brand_ids: torch.Tensor,
                           container_ids: torch.Tensor, device):
    """Plain PyTorch version of kernel K13: rows offset .. offset+n-1 of
    `table`, four int64 columns."""
    rid = offset + torch.arange(n, dtype=torch.int64, device=device)
    if table == "part":
        keys = rid + 1
        brand, container, price = _part_cols(keys, brand_ids, container_ids)
        return keys, brand, container, price
    h = splitmix64(rid ^ 0x71F3)
    partkey = 1 + umod(h, NUM_PARTS)
    hq = splitmix64(rid ^ 0x9D2C)
    quantity = 1 + umod(hq, 50)
    _, _, price = _part_cols(partkey, brand_ids, container_ids)
    extended = quantity * price
    orderkey = rid // 4 + 1
    return orderkey, partkey, quantity, extended


_P = ctypes.c_void_p

# K13. Replaces connectors/tpch.py:TpchGenerator._gen_impl (77) with
# _part_cols (47).
K_TPCH = kernels.register(kernels.CudaKernel(
    "tpch",
    replaces="risingwave_tpu/connectors/tpch.py:77",
    functions={"rw_tpch": [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                           _P, ctypes.c_int, _P, ctypes.c_int,
                           _P, _P, _P, _P, _P]}))


def gen_tpch_columns(table: str, offset: int, n: int,
                     brand_ids: torch.Tensor, container_ids: torch.Tensor,
                     device) -> tuple[torch.Tensor, ...]:
    """The four int64 columns of `table` on `device`: kernel K13 on a
    CUDA device, the plain version on the CPU."""
    device = resolve_device(device)
    if table not in _TABLE_CODES:
        raise ValueError(f"unknown tpch table {table!r}")
    if device.type == "cpu":
        return gen_tpch_columns_plain(table, offset, n, brand_ids,
                                      container_ids, device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    for ids, size in ((brand_ids, len(BRANDS)),
                      (container_ids, len(CONTAINERS))):
        if ids.device != device or ids.dtype != torch.int64 \
                or ids.shape != (size,) or not ids.is_contiguous():
            raise ValueError("vocab id tables must be int64 on the device, "
                             "one entry a string")
    cols = [torch.empty(n, dtype=torch.int64, device=device)
            for _ in range(4)]
    K_TPCH.launches += 1
    K_TPCH.call("rw_tpch", _TABLE_CODES[table], offset, n,
                kernels.ptr(brand_ids), brand_ids.shape[0],
                kernels.ptr(container_ids), container_ids.shape[0],
                *(kernels.ptr(c) for c in cols), kernels.stream_of(cols[0]))
    return tuple(cols)


class TpchGenerator:
    """Connector protocol: next_chunk() / seek(offset) / offset."""

    def __init__(self, table: str, chunk_size: int = 4096,
                 start_offset: int = 0, device="cuda"):
        if table not in TPCH_SCHEMAS:
            raise ValueError(f"unknown tpch table {table!r}")
        self.device = resolve_device(device)
        self.table = table
        self.chunk_size = chunk_size
        self.offset = start_offset
        self.schema = TPCH_SCHEMAS[table]
        ids = vocab_ids()
        self._brand_ids = torch.tensor(ids["tpch_brand"], dtype=torch.int64,
                                       device=self.device)
        self._container_ids = torch.tensor(ids["tpch_container"],
                                           dtype=torch.int64,
                                           device=self.device)
        self._vis = torch.ones(chunk_size, dtype=torch.bool,
                               device=self.device)
        self._ops = torch.zeros(chunk_size, dtype=torch.int8,
                                device=self.device)

    def next_chunk(self) -> StreamChunk:
        cols = gen_tpch_columns(self.table, self.offset, self.chunk_size,
                                self._brand_ids, self._container_ids,
                                self.device)
        self.offset += self.chunk_size
        return StreamChunk(tuple(Column(c) for c in cols), self._ops,
                           self._vis, self.schema)

    def seek(self, offset: int) -> None:
        self.offset = offset
