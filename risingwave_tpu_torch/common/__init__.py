from .types import DataType, Field, Schema, StringDictionary, GLOBAL_DICT, schema
from .chunk import (
    Column,
    StreamChunk,
    op_sign,
    OP_INSERT,
    OP_DELETE,
    OP_UPDATE_DELETE,
    OP_UPDATE_INSERT,
)
from .vnode import VNODE_COUNT, compute_vnodes_numpy, crc32_numpy
from .epoch import EpochPair, next_epoch, INVALID_EPOCH

__all__ = [
    "DataType", "Field", "Schema", "StringDictionary", "GLOBAL_DICT", "schema",
    "Column", "StreamChunk", "op_sign",
    "OP_INSERT", "OP_DELETE", "OP_UPDATE_DELETE", "OP_UPDATE_INSERT",
    "VNODE_COUNT", "compute_vnodes_numpy", "crc32_numpy",
    "EpochPair", "next_epoch", "INVALID_EPOCH",
]
