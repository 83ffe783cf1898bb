from .actor import Actor
from .executor import Executor, StatelessUnaryExecutor
from .hash_agg import HashAggExecutor
from .hop_window import HopWindowExecutor
from .materialize import ConflictBehavior, MaterializeExecutor
from .message import Barrier, BarrierKind, Watermark
from .sink import DeviceBlackholeSinkExecutor
from .source import SourceExecutor

__all__ = ["Actor", "Executor", "StatelessUnaryExecutor", "HashAggExecutor",
           "HopWindowExecutor", "ConflictBehavior", "MaterializeExecutor",
           "Barrier", "BarrierKind", "Watermark",
           "DeviceBlackholeSinkExecutor", "SourceExecutor"]
