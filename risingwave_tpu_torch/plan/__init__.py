from .graph import Exchange, Fragment, Node, StreamGraph
from .build import (
    BUILDERS, BuildEnv, Deployment, build_graph, register_builder,
)

__all__ = ["Exchange", "Fragment", "Node", "StreamGraph", "BUILDERS",
           "BuildEnv", "Deployment", "build_graph", "register_builder"]
