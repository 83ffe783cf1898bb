"""risingwave_tpu_torch — the streaming engine on PyTorch and CUDA (H100).

A second build of the engine in `risingwave_tpu/`, written against
PyTorch instead of JAX. It imports torch, numpy and the standard library
only: never jax, never the JAX package (importing that package turns on
x64 and the XLA compile cache as a side effect).

The first slice carries Nexmark q5 — source -> HOP window -> hash agg ->
materialized view — under the barrier coordinator with volatile state.
Every entry point takes a `device` argument that defaults to "cuda";
constructing one without a card raises unless the caller asked for the
CPU, where each hand-written kernel's plain PyTorch version runs.

Layer map (module paths mirror the JAX package):
  meta/        barrier coordinator
  stream/      executors (source, hop_window, hash_agg, materialize,
               sink) and the actor loop
  expr/        aggregate specs
  state/       state store, row serde, state table
  ops/         the bucketed hash table and the kernel build/registry
  common/      chunks, types, epochs, vnodes
  connectors/  the Nexmark generator
  csrc/        CUDA C++ sources of the hand-written Hopper kernels
"""

__version__ = "0.1.0"
