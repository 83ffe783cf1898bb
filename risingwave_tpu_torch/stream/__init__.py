from .actor import Actor
from .align import barrier_align
from .exchange import (
    BroadcastDispatcher, Channel, ChannelInput, Dispatcher, SimpleDispatcher,
)
from .executor import (
    Executor, StatefulUnaryExecutor, StatelessUnaryExecutor,
)
from .hash_agg import HashAggExecutor
from .hop_window import HopWindowExecutor
from .materialize import ConflictBehavior, MaterializeExecutor
from .message import Barrier, BarrierKind, StopMutation, Watermark
from .misc import NoOpExecutor
from .project import FilterExecutor, ProjectExecutor
from .retract_top_n import RetractableTopNExecutor
from .row_id import RowIdGenExecutor
from .sink import DeviceBlackholeSinkExecutor
from .snapshot_join_agg import SnapshotJoinAggExecutor
from .sorted_join import SortedJoinExecutor
from .source import SourceExecutor

__all__ = ["Actor", "barrier_align", "BroadcastDispatcher", "Channel",
           "ChannelInput", "Dispatcher", "SimpleDispatcher", "Executor",
           "StatefulUnaryExecutor", "StatelessUnaryExecutor",
           "FilterExecutor", "RetractableTopNExecutor",
           "HashAggExecutor", "HopWindowExecutor",
           "ConflictBehavior", "MaterializeExecutor", "Barrier",
           "BarrierKind", "StopMutation", "Watermark", "NoOpExecutor",
           "ProjectExecutor", "RowIdGenExecutor",
           "DeviceBlackholeSinkExecutor", "SnapshotJoinAggExecutor",
           "SortedJoinExecutor", "SourceExecutor"]
