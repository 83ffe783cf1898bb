"""Differential tests: the port's Nexmark generator (plain PyTorch
version of kernel K1 on the CPU) against the JAX package's, bit for bit.
VARCHAR ids are compared decoded, each through its own package's
dictionary (the two processes' ids need not agree)."""

import numpy as np
import pytest

from risingwave_tpu.common.types import GLOBAL_DICT as JAX_DICT
from risingwave_tpu.connectors.nexmark import (
    NexmarkConfig as JaxConfig, NexmarkGenerator as JaxGenerator,
)


@pytest.fixture(autouse=True, scope="module")
def _port():
    """Import torch and the port when these tests run, not at collection:
    an xdist worker then runs the JAX tests before them without torch
    (the sharded-join recovery tests abort more often with it loaded)."""
    global PORT_DICT, NexmarkConfig, NexmarkGenerator, gen_bid_columns_plain
    global vocab_ids, splitmix64, umod
    from risingwave_tpu_torch.common.types import GLOBAL_DICT as PORT_DICT
    from risingwave_tpu_torch.connectors.nexmark import (
        NexmarkConfig, NexmarkGenerator, gen_bid_columns_plain, vocab_ids,
    )
    from risingwave_tpu_torch.ops.hashing import splitmix64, umod


def _decoded(cols, schema, dictionary):
    out = []
    for c, f in zip(cols, schema):
        if f.data_type.is_dict_encoded:
            out.append(dictionary.decode_many(c))
        else:
            out.append(np.asarray(c).tolist())
    return out


@pytest.mark.parametrize("table", ["bid", "person", "auction"])
@pytest.mark.parametrize("offset", [0, 4093, 987_654_321, 1_000_000_000_007])
def test_generator_matches_jax(table, offset):
    n = 257
    cfg_kw = dict(inter_event_us=50_000, in_flight_auctions=97,
                  num_active_people=1009)
    jgen = JaxGenerator(table, chunk_size=n, cfg=JaxConfig(**cfg_kw),
                        start_offset=offset)
    pgen = NexmarkGenerator(table, chunk_size=n, cfg=NexmarkConfig(**cfg_kw),
                            start_offset=offset, device="cpu")
    jcols, jops = jgen.next_chunk().to_numpy()
    pcols, pops = pgen.next_chunk().to_numpy()
    assert [f.name for f in pgen.schema] == [f.name for f in jgen.schema]
    for jc, pc, f in zip(jcols, pcols, pgen.schema):
        assert pc.dtype == jc.dtype, f.name
    assert _decoded(pcols, pgen.schema, PORT_DICT) == \
        _decoded(jcols, jgen.schema, JAX_DICT)
    assert np.array_equal(jops, pops)
    assert pgen.offset == jgen.offset == offset + n
    assert pgen.current_watermark() == jgen.current_watermark()


def test_bid_plain_is_bit_identical_in_ints():
    """The integer columns equal JAX's exactly at a deep offset with the
    default config (q5's inter_event_us=2)."""
    off = 10**12 + 12345
    jcols, _ = JaxGenerator("bid", chunk_size=1024,
                            cfg=JaxConfig(inter_event_us=2),
                            start_offset=off).next_chunk().to_numpy()
    vocabs = {k: __import__("torch").tensor(v, dtype=__import__("torch").int32)
              for k, v in vocab_ids().items()}
    pcols = gen_bid_columns_plain(off, 1024, NexmarkConfig(inter_event_us=2),
                                  vocabs, "cpu")
    for j in (0, 1, 2, 5):
        assert np.array_equal(pcols[j].numpy(), jcols[j])


def test_unsigned_helpers_match_numpy_uint64():
    import torch
    rng = np.random.default_rng(7)
    x = rng.integers(-2**63, 2**63 - 1, size=4096, dtype=np.int64)
    with np.errstate(over="ignore"):
        u = x.view(np.uint64)
        u = u + np.uint64(0x9E3779B97F4A7C15)
        u = (u ^ (u >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        u = (u ^ (u >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        u = u ^ (u >> np.uint64(31))
    got = splitmix64(torch.from_numpy(x))
    assert np.array_equal(got.numpy().view(np.uint64), u)
    for m in (1, 5, 97, 1000, 2**31 - 1):
        assert np.array_equal(umod(got, m).numpy(),
                              (u % np.uint64(m)).astype(np.int64))
