from .actor import Actor
from .align import barrier_align
from .dynamic import DynamicFilterExecutor, NowExecutor
from .exchange import (
    BroadcastDispatcher, Channel, ChannelInput, Dispatcher, SimpleDispatcher,
    TapDispatcher,
)
from .eowc_over_window import EowcOverWindowExecutor
from .executor import (
    Executor, StatefulUnaryExecutor, StatelessUnaryExecutor,
)
from .general_over_window import GeneralOverWindowExecutor, WindowSpec
from .hash_agg import HashAggExecutor
from .hop_window import HopWindowExecutor
from .materialize import ConflictBehavior, MaterializeExecutor
from .message import Barrier, BarrierKind, StopMutation, Watermark
from .misc import NoOpExecutor
from .project import FilterExecutor, ProjectExecutor
from .retract_top_n import RetractableTopNExecutor
from .row_id import RowIdGenExecutor
from .simple_agg import SimpleAggExecutor
from .sink import DeviceBlackholeSinkExecutor
from .snapshot_join_agg import SnapshotJoinAggExecutor
from .sorted_join import SortedJoinExecutor
from .source import SourceExecutor

__all__ = ["Actor", "barrier_align", "BroadcastDispatcher", "Channel",
           "ChannelInput", "Dispatcher", "SimpleDispatcher", "TapDispatcher",
           "Executor",
           "DynamicFilterExecutor", "NowExecutor",
           "StatefulUnaryExecutor", "StatelessUnaryExecutor",
           "EowcOverWindowExecutor", "GeneralOverWindowExecutor",
           "SimpleAggExecutor", "WindowSpec",
           "FilterExecutor", "RetractableTopNExecutor",
           "HashAggExecutor", "HopWindowExecutor",
           "ConflictBehavior", "MaterializeExecutor", "Barrier",
           "BarrierKind", "StopMutation", "Watermark", "NoOpExecutor",
           "ProjectExecutor", "RowIdGenExecutor",
           "DeviceBlackholeSinkExecutor", "SnapshotJoinAggExecutor",
           "SortedJoinExecutor", "SourceExecutor"]
