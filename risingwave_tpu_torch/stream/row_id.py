"""RowIdGen executor — appends a `_row_id` Serial column
(port of risingwave_tpu/stream/row_id.py).

Append-only streams without a pk get serial row ids so downstream state
has a key. Layout: row_id = instance(8b) << 55 | seq(55b), seq seeded
and re-floored from each barrier's physical epoch ms << 15, so ids never
collide across restarts. The ids of a chunk are one launch of kernel K8
(`csrc/row_id.cu`): base + arange(capacity).
"""

from __future__ import annotations

import ctypes

import torch

from ..common.chunk import Column, StreamChunk
from ..common.epoch import to_physical
from ..common.types import DataType, Field, Schema
from ..ops import kernels
from .executor import Executor, StatelessUnaryExecutor
from .message import Barrier

_SEQ_PER_MS_BITS = 15

# K8. Replaces stream/row_id.py:RowIdGenExecutor._step_impl (49).
K_ROW_ID = kernels.register(kernels.CudaKernel(
    "row_id",
    replaces="risingwave_tpu/stream/row_id.py:49",
    functions={"rw_row_ids": [ctypes.c_longlong, ctypes.c_longlong,
                              ctypes.c_void_p, ctypes.c_void_p]}))


def row_ids_plain(base: int, n: int, device) -> torch.Tensor:
    """Plain PyTorch version of kernel K8."""
    return base + torch.arange(n, dtype=torch.int64, device=device)


def row_ids(base: int, n: int, device) -> torch.Tensor:
    """Kernel K8 on a CUDA device, the plain version on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return row_ids_plain(base, n, device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = torch.empty(n, dtype=torch.int64, device=device)
    K_ROW_ID.launches += 1
    K_ROW_ID.call("rw_row_ids", base, n, kernels.ptr(out),
                  kernels.stream_of(out))
    return out


class RowIdGenExecutor(StatelessUnaryExecutor):
    def __init__(self, input: Executor, instance: int = 0,
                 row_id_name: str = "_row_id"):
        super().__init__(input)
        self.instance = instance
        self._next_seq = 0
        self.schema = Schema(input.schema.fields
                             + (Field(row_id_name, DataType.SERIAL),))
        self.pk_indices = (len(self.schema) - 1,)
        self.identity = "RowIdGen"

    def on_barrier(self, barrier: Barrier) -> None:
        # epoch physical time floors the sequence => restart-safe ids
        self._next_seq = max(self._next_seq,
                             to_physical(barrier.epoch.curr)
                             << _SEQ_PER_MS_BITS)

    def map_chunk(self, chunk: StreamChunk) -> StreamChunk:
        base = (self.instance << 55) | self._next_seq
        self._next_seq += chunk.capacity
        ids = row_ids(base, chunk.capacity, chunk.device)
        return StreamChunk(chunk.columns + (Column(ids),), chunk.ops,
                           chunk.vis, self.schema)
