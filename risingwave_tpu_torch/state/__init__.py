from .store import MemoryStateStore, StateStore, WriteBatch
from .state_table import StateTable, StateTableError
from .hummock import HummockStateStore
from .object_store import InMemObjectStore, LocalFsObjectStore, ObjectStore

__all__ = ["MemoryStateStore", "StateStore", "WriteBatch", "StateTable",
           "StateTableError", "HummockStateStore", "InMemObjectStore",
           "LocalFsObjectStore", "ObjectStore"]
