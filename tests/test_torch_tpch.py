"""The port's TPC-H generator (kernel K13's plain version on the CPU)
against the JAX package's: both tables bit-identical for several start
offsets and chunk sizes. Brand and container are dictionary ids minted
by each package's own dictionary, so they are compared as the strings
they decode to."""

import numpy as np
import pytest

from risingwave_tpu.common.types import GLOBAL_DICT as JDICT
from risingwave_tpu.connectors.tpch import TpchGenerator as JTpch


@pytest.fixture(autouse=True, scope="module")
def _port():
    """Import torch and the port when these tests run, not at collection:
    an xdist worker then runs the JAX tests before them without torch
    (the sharded-join recovery tests abort more often with it loaded)."""
    global PDICT, PTpch, tpch
    from risingwave_tpu_torch.common.types import GLOBAL_DICT as PDICT
    from risingwave_tpu_torch.connectors import tpch
    from risingwave_tpu_torch.connectors.tpch import TpchGenerator as PTpch


def _chunks(gen, n_chunks):
    out = []
    for _ in range(n_chunks):
        c = gen.next_chunk()
        out.append([np.asarray(col.data) if not hasattr(col.data, "numpy")
                    else col.data.numpy() for col in c.columns])
    return [np.concatenate(x) for x in zip(*out)]


@pytest.mark.parametrize("table", ["part", "lineitem"])
@pytest.mark.parametrize("offset,chunk", [(0, 256), (5_999_872, 256),
                                          ((1 << 40) + 3, 100)])
def test_tables_bit_identical_to_jax(table, offset, chunk):
    j = _chunks(JTpch(table, chunk_size=chunk, start_offset=offset), 2)
    gen = PTpch(table, chunk_size=chunk, start_offset=offset, device="cpu")
    p = _chunks(gen, 2)
    assert gen.offset == offset + 2 * chunk
    assert [c.dtype for c in p] == [np.int64] * 4
    assert [f.name for f in gen.schema] == \
        [f.name for f in tpch.TPCH_SCHEMAS[table]]
    for k in range(4):
        if table == "part" and k in (1, 2):
            assert PDICT.decode_many(p[k]) == JDICT.decode_many(j[k])
        else:
            np.testing.assert_array_equal(p[k], j[k], err_msg=f"col {k}")


def test_seek_and_vocabularies():
    gen = PTpch("part", chunk_size=1000, device="cpu")
    first = _chunks(gen, 1)
    gen.seek(0)
    again = _chunks(gen, 1)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    # the part universe: keys 1..1000, every brand and container drawn,
    # prices in [900, 1100)
    np.testing.assert_array_equal(first[0], np.arange(1, 1001))
    assert set(PDICT.decode_many(first[1])) == set(tpch.BRANDS)
    assert set(PDICT.decode_many(first[2])) == set(tpch.CONTAINERS)
    assert first[3].min() >= 900 and first[3].max() < 1100
    li = _chunks(PTpch("lineitem", chunk_size=4096, device="cpu"), 1)
    price = dict(zip(first[0].tolist(), first[3].tolist()))
    want = li[2] * np.asarray([price[k] for k in li[1].tolist()])
    np.testing.assert_array_equal(li[3], want)
    assert li[1].min() >= 1 and li[1].max() <= tpch.NUM_PARTS
    assert li[2].min() == 1 and li[2].max() == 50
