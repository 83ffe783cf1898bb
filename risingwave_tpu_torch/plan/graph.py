"""Fragment-graph IR — the declarative seam between planning and execution.

The port's own copy of the JAX package's module of the same path (pure
Python, copied whole so the port imports nothing of that package).

Reference: `StreamNode` proto (proto/stream_plan.proto:730) is THE contract
between the frontend planner and the stream engine; fragments are the plan
cut at Exchange nodes (stream_fragmenter/mod.rs:116), each deployed as N
parallel actors over vnode bitmaps (proto/stream_plan.proto:834-876).

TPU build keeps the same shape, python-native: a `StreamGraph` of
`Fragment`s; each fragment is a tree of `Node`s (executor specs) whose
leaves may be `Exchange` refs consuming an upstream fragment's output.
`build_graph` (build.py) is the `from_proto`-style registry
(from_proto/mod.rs:105-126) that instantiates executors, channels,
dispatchers, actors, and state tables from this IR — the plugin seam every
later feature (frontend, scaling mutations, multi-host deploy) targets.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Union


@dataclass(frozen=True)
class Exchange:
    """Leaf input consuming the output of an upstream fragment."""

    upstream: int  # fragment id


@dataclass
class Node:
    """One executor spec: `kind` selects a registered builder, `args` are
    its kwargs (expression objects welcome — this IR is in-process; the
    wire form serializes them like expr.proto when remote deploy lands)."""

    kind: str
    args: dict = field(default_factory=dict)
    inputs: tuple[Union["Node", Exchange], ...] = ()

    def __post_init__(self):
        self.inputs = tuple(self.inputs)


@dataclass
class Fragment:
    """A pipeline-local executor tree plus its OUTPUT dispatch strategy.

    parallelism > 1 instantiates the tree once per actor; hash dispatch
    partitions by vnode(dist_keys) across the actor set, and every
    consumer of a parallel fragment merges its actors' outputs with
    barrier alignment (dispatch.rs / merge.rs semantics)."""

    fid: int
    root: Node
    dispatch: str = "simple"            # simple | broadcast | hash
    dist_key_indices: tuple[int, ...] = ()
    parallelism: int = 1
    # "host:port" of a fragment worker process — the build places this
    # fragment there over the DCN tier (stream/remote_fragment.py)
    remote_worker: object = None

    def __post_init__(self):
        assert self.dispatch in ("simple", "broadcast", "hash")
        if self.dispatch == "hash":
            assert self.dist_key_indices, "hash dispatch needs dist keys"
        assert self.parallelism >= 1


@dataclass
class StreamGraph:
    fragments: dict[int, Fragment] = field(default_factory=dict)

    def add(self, fragment: Fragment) -> Fragment:
        assert fragment.fid not in self.fragments
        self.fragments[fragment.fid] = fragment
        return fragment

    def edges(self) -> list[tuple[int, int, int]]:
        """(up_fid, down_fid, k) per Exchange LEAF, where k numbers the
        occurrences of the same (up, down) pair — a fragment may consume
        one upstream through several inputs (self-join), and each such
        edge needs its own channel set. Leaf order is the pre-order walk
        of each fragment tree (the same order build_graph walks)."""
        out: list[tuple[int, int, int]] = []
        for f in self.fragments.values():
            seen: dict[int, int] = {}

            def walk(n):
                if isinstance(n, Exchange):
                    k = seen.get(n.upstream, 0)
                    seen[n.upstream] = k + 1
                    out.append((n.upstream, f.fid, k))
                    return
                for i in n.inputs:
                    walk(i)
            walk(f.root)
        return out

    def consumers(self, fid: int) -> list[tuple[int, int]]:
        """(down_fid, k) edges consuming fragment `fid`, in edge order."""
        return [(d, k) for u, d, k in self.edges() if u == fid]

    def topo_order(self) -> list[int]:
        """Upstream-first order (DAG check included)."""
        deps: dict[int, set[int]] = {}
        for fid, f in self.fragments.items():
            ups: set[int] = set()

            def walk(n):
                if isinstance(n, Exchange):
                    ups.add(n.upstream)
                    return
                for i in n.inputs:
                    walk(i)
            walk(f.root)
            deps[fid] = ups
        out: list[int] = []
        seen: set[int] = set()
        visiting: set[int] = set()

        def visit(fid: int):
            if fid in seen:
                return
            if fid in visiting:
                raise ValueError(f"cycle through fragment {fid}")
            visiting.add(fid)
            for up in sorted(deps[fid]):
                visit(up)
            visiting.discard(fid)
            seen.add(fid)
            out.append(fid)
        for fid in sorted(self.fragments):
            visit(fid)
        return out


def render_node(node, depth: int = 0) -> list:
    """Plan-node tree as indented text (EXPLAIN + plan goldens)."""
    if isinstance(node, Exchange):
        return [f"{'  ' * depth}exchange({node.upstream})"]
    extra = ""
    if node.kind in ("sorted_join", "hash_join"):
        extra = (f" lkeys={node.args['left_key_indices']}"
                 f" rkeys={node.args['right_key_indices']}")
    if node.kind == "project":
        extra = f" names={node.args.get('names')}"
    out = [f"{'  ' * depth}{node.kind}{extra}"]
    for i in node.inputs:
        out.extend(render_node(i, depth + 1))
    return out


def render_graph(graph: "StreamGraph") -> list:
    """Whole fragment graph as text lines (reference: EXPLAIN output /
    the planner_test YAML snapshots, frontend/planner_test)."""
    lines = []
    for fid in sorted(graph.fragments):
        f = graph.fragments[fid]
        remote = (f" remote={f.remote_worker}"
                  if getattr(f, "remote_worker", None) else "")
        lines.append(
            f"fragment {fid} dispatch={f.dispatch} "
            f"parallelism={f.parallelism} "
            f"dist={tuple(f.dist_key_indices)}{remote}")
        for ln in render_node(f.root, 1):
            lines.append(ln)
    return lines
