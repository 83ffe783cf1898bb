from .store import MemoryStateStore, StateStore, WriteBatch
from .state_table import StateTable, StateTableError

__all__ = ["MemoryStateStore", "StateStore", "WriteBatch", "StateTable",
           "StateTableError"]
