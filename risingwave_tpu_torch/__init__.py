"""risingwave_tpu_torch — the streaming engine on PyTorch and CUDA (H100).

A second build of the engine in `risingwave_tpu/`, written against
PyTorch instead of JAX. It imports torch, numpy and the standard library
only: never jax, never the JAX package (importing that package turns on
x64 and the XLA compile cache as a side effect).

It runs Nexmark q5, q7, q8 and TPC-H q17 under the barrier coordinator
with volatile state, and q7 with durable state on a Hummock LSM store
(checkpoints, crash recovery); q7, q8, q17 and q1 enter through the
port's own SQL session (`frontend.Session`). Every entry point takes a `device` argument that
defaults to "cuda"; constructing one without a card raises unless the
caller asked for the CPU, where each hand-written kernel's plain PyTorch
version runs.

Layer map (module paths mirror the JAX package):
  frontend/    SQL parser, binder (planner) and Session
  plan/        fragment-graph IR and the builder that deploys it
  meta/        barrier coordinator and its checkpoint uploader
  stream/      executors (source, hop_window, project, hash_agg,
               sorted_join, snapshot_join_agg, row_id, materialize,
               sink) and the actor loop
  expr/        expression IR, the K5 program compiler, aggregate specs
  state/       state stores (in-memory, Hummock LSM over an object
               store), SSTs, row serde, state table
  ops/         the bucketed hash table, sort and compaction, and the
               kernel build/registry
  common/      chunks, types, epochs, vnodes
  utils/       packed device-to-host fetches
  connectors/  the Nexmark and TPC-H generators
  csrc/        CUDA C++ sources of the hand-written Hopper kernels
"""

__version__ = "0.1.0"
