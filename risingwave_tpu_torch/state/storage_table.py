"""Rows to columns (the one function of
risingwave_tpu/state/storage_table.py that the port needs: a durable
top-N's recovery turns its stored rows back into a chunk).

Left out of this slice (ROADMAP Queue A): the batch storage table and
its scans.
"""

from __future__ import annotations

import numpy as np

from ..common.types import Schema


def rows_to_columns(schema: Schema, rows: list
                    ) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """(columns, validity masks) of row tuples: a None cell becomes 0
    with valid False."""
    cols, valids = [], []
    for j, f in enumerate(schema):
        vals = [r[j] for r in rows]
        valid = np.asarray([v is not None for v in vals], dtype=bool)
        arr = np.asarray([0 if v is None else v for v in vals],
                         dtype=f.data_type.np_dtype)
        cols.append(arr)
        valids.append(valid)
    return cols, valids
