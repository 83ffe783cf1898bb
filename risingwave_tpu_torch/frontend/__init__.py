from .binder import BindError
from .session import Catalog, MvDef, Session, SinkDef, SourceDef
from .sql import SqlError, parse

__all__ = ["BindError", "Catalog", "MvDef", "Session", "SinkDef",
           "SourceDef", "SqlError", "parse"]
