"""Columnar chunks — the data quantum flowing between executors
(port of risingwave_tpu/common/chunk.py).

A chunk is a fixed-capacity struct of tensors. The row count is dynamic
only through the visibility mask, so every executor step sees one shape.

Ops: INSERT=0  DELETE=1  UPDATE_DELETE=2  UPDATE_INSERT=3 (int8).
`op_sign` maps insert-like ops to +1 and delete-like ones to -1.

Left out of this slice (ROADMAP Queue A): ChunkCoalescer and its pad /
concat programs, StreamChunkBuilder, `from_numpy` (the port builds
chunks from numpy through `interop.chunk_from_numpy`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .types import Schema

OP_INSERT = 0
OP_DELETE = 1
OP_UPDATE_DELETE = 2
OP_UPDATE_INSERT = 3


def op_sign(ops: torch.Tensor) -> torch.Tensor:
    """+1 for Insert/UpdateInsert, -1 for Delete/UpdateDelete (int32)."""
    is_insert = (ops == OP_INSERT) | (ops == OP_UPDATE_INSERT)
    return torch.where(is_insert, 1, -1).to(torch.int32)


@dataclass
class Column:
    """One column: fixed-width data + optional validity (None = all valid)."""

    data: torch.Tensor
    valid: Optional[torch.Tensor] = None  # bool mask, True = non-null

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    def valid_mask(self) -> torch.Tensor:
        if self.valid is None:
            return torch.ones(self.capacity, dtype=torch.bool,
                              device=self.data.device)
        return self.valid

    def take(self, idx: torch.Tensor) -> "Column":
        return Column(self.data[idx],
                      None if self.valid is None else self.valid[idx])


@dataclass
class StreamChunk:
    """ops + columns + visibility."""

    columns: tuple[Column, ...]
    ops: torch.Tensor       # int8 [CAP]
    vis: torch.Tensor       # bool [CAP]
    schema: Schema

    @property
    def capacity(self) -> int:
        return self.ops.shape[0]

    @property
    def device(self) -> torch.device:
        return self.ops.device

    def cardinality(self) -> torch.Tensor:
        """Number of visible rows (device scalar)."""
        return self.vis.sum(dtype=torch.int64)

    def take(self, idx: torch.Tensor, vis: torch.Tensor) -> "StreamChunk":
        return StreamChunk(tuple(c.take(idx) for c in self.columns),
                           self.ops[idx], vis, self.schema)

    def compact(self) -> "StreamChunk":
        """Move visible rows to the front (stable). Keeps capacity."""
        order = torch.argsort((~self.vis).to(torch.int8), stable=True)
        n = self.cardinality()
        new_vis = torch.arange(self.capacity, device=self.device) < n
        return self.take(order, new_vis)

    # -- host I/O ------------------------------------------------------
    def to_numpy(self) -> tuple[list[np.ndarray], np.ndarray]:
        """Visible rows only -> (columns, ops). Device->host sync."""
        vis = self.vis.cpu().numpy()
        cols = [c.data.cpu().numpy()[vis] for c in self.columns]
        return cols, self.ops.cpu().numpy()[vis]

    def to_rows(self) -> list[tuple]:
        """Visible rows as python tuples (op, values...), NULL lanes as
        None."""
        vis = self.vis.cpu().numpy()
        ops = self.ops.cpu().numpy()[vis]
        cols = [c.data.cpu().numpy()[vis] for c in self.columns]
        valids = [None if c.valid is None else c.valid.cpu().numpy()[vis]
                  for c in self.columns]
        out = []
        for r in range(len(ops)):
            out.append((int(ops[r]), tuple(
                c[r].item() if v is None or v[r] else None
                for c, v in zip(cols, valids))))
        return out

