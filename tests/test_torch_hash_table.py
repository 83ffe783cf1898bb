"""Differential tests: the port's bucketed hash table (plain PyTorch
version of kernel K3 on the CPU) against the JAX package's: identical
slots, n_unresolved and table contents after every batch, for the cases
of tests/test_hash_table.py (collision-heavy, overflow, two-choice fill,
multi-column) and skewed streams like Nexmark's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from risingwave_tpu.ops import hash_table as jht


@pytest.fixture(autouse=True, scope="module")
def _port():
    """Import torch and the port when these tests run, not at collection:
    an xdist worker then runs the JAX tests before them without torch
    (the sharded-join recovery tests abort more often with it loaded)."""
    global torch, pht, hash_table_from_numpy
    import torch
    from risingwave_tpu_torch.ops import hash_table as pht
    from risingwave_tpu_torch.interop import hash_table_from_numpy


# one compiled program per shape instead of op-by-op dispatch
_jax_insert = jax.jit(jht.lookup_or_insert)


def _run_both(capacity, np_dtypes, batches, prefill=None):
    """Feed the same (keys, active) batches to both tables; compare slots,
    n_unresolved and the whole table after each batch."""
    jt = jht.HashTable.empty(capacity, [jnp.dtype(d) for d in np_dtypes])
    pt = pht.HashTable.empty(
        capacity, [torch.from_numpy(np.zeros(1, d)).dtype for d in np_dtypes],
        "cpu")
    if prefill is not None:
        keys, occ = prefill
        jt = jht.HashTable(tuple(jnp.asarray(k) for k in keys),
                           jnp.asarray(occ))
        pt = hash_table_from_numpy(keys, occ, device="cpu")
    for keys, active in batches:
        keys = [np.asarray(k, dtype=d) for k, d in zip(keys, np_dtypes)]
        jt, js, jn = _jax_insert(
            jt, [jnp.asarray(k) for k in keys], jnp.asarray(active))
        pt, ps, pn = pht.lookup_or_insert(
            pt, [torch.from_numpy(k) for k in keys],
            torch.from_numpy(np.asarray(active)))
        assert ps.dtype == torch.int32
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        assert int(pn) == int(jn)
        np.testing.assert_array_equal(pt.occupied.numpy(),
                                      np.asarray(jt.occupied))
        for a, b in zip(pt.keys, jt.keys):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return jt, pt


def test_insert_then_lookup():
    keys = [5, 17, 5, 99, 17, 5]
    jt, pt = _run_both(64, [np.int64], [([keys], np.ones(6, bool))])
    q = np.asarray([99, 5, 1234], dtype=np.int64)
    np.testing.assert_array_equal(
        pht.lookup(pt, [torch.from_numpy(q)], torch.ones(3, dtype=torch.bool)
                   ).numpy(),
        np.asarray(jht.lookup(jt, [jnp.asarray(q)], jnp.ones(3, bool))))


def test_inactive_rows_ignored():
    _run_both(32, [np.int64], [([[1, 2, 3, 4]],
                                np.asarray([True, False, True, False]))])


def test_collision_heavy():
    _run_both(32, [np.int64], [([np.arange(12) * 1000], np.ones(12, bool))])


@pytest.mark.parametrize("n", [33, 64, 300])
def test_overflow_reported(n):
    jt, pt = _run_both(32, [np.int64], [([np.arange(n)], np.ones(n, bool))])
    assert int(pt.occupied.sum()) <= 32


def test_incremental_fill_two_choice():
    batches = [([np.arange(s, s + 4) * 7919], np.ones(4, bool))
               for s in range(0, 28, 4)]
    _run_both(32, [np.int64], batches)


def test_multi_column_keys_with_negative_int32():
    a = [1, 1, 2, 2, -3, -3]
    b = [10, 20, 10, 10, -1, -(2**31)]
    _run_both(64, [np.int64, np.int32], [([a, b], np.ones(6, bool))])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_skewed_stream_like_nexmark(seed):
    """Hot keys repeated within and across batches, two key columns
    (auction, window_start), a few inactive rows, a table driven past
    its two-choice comfort zone so some batches overflow."""
    rng = np.random.default_rng(seed)
    batches = []
    for b in range(6):
        n = 200
        hot = rng.random(n) < 0.9
        auction = np.where(hot, 1000 + b, rng.integers(900, 1100, n))
        ws = rng.integers(0, 5, n) * 2_000_000 + b * 2_000_000
        active = rng.random(n) < 0.95
        batches.append(([auction, ws], active))
    _run_both(256, [np.int64, np.int64], batches)


def test_prefilled_half_load():
    """Carry a half-full table in through interop, then insert more."""
    rng = np.random.default_rng(5)
    C = 1024
    jt = jht.HashTable.empty(C, [jnp.int64])
    pre = rng.choice(10**9, size=C // 2, replace=False).astype(np.int64)
    jt, _, _ = _jax_insert(jt, [jnp.asarray(pre)], jnp.ones(C // 2, bool))
    keys = (np.asarray(jt.keys[0]),)
    occ = np.asarray(jt.occupied)
    new = np.concatenate([pre[:100], rng.integers(0, 10**9, 400)])
    _run_both(C, [np.int64], [([new], np.ones(500, bool))],
              prefill=(keys, occ))


def test_compact_mask_and_lexsort_match_jax():
    rng = np.random.default_rng(3)
    mask = rng.random(300) < 0.3
    jsel, jn = jht.compact_mask(jnp.asarray(mask))
    psel, pn = pht.compact_mask(torch.from_numpy(mask))
    np.testing.assert_array_equal(psel.numpy(), np.asarray(jsel))
    assert int(pn) == int(jn)
    a = rng.integers(0, 5, 300)
    b = rng.integers(0, 3, 300)
    np.testing.assert_array_equal(
        pht.stable_lexsort([torch.from_numpy(a), torch.from_numpy(b)]).numpy(),
        np.asarray(jht.stable_lexsort((jnp.asarray(a), jnp.asarray(b)))))


def test_needs_rebuild_policy_matches_jax():
    for occ, live, cap in [(10, 10, 100), (80, 10, 100), (80, 60, 100),
                           (71, 24, 100), (71, 25, 100)]:
        assert pht.needs_rebuild(occ, live, cap) == \
            jht.needs_rebuild(occ, live, cap)


def test_k3_invariant_checker_accepts_reordering_and_rejects_faults():
    """chip_smoke.k3_invariants holds K3 against the plain version on the
    card. Here both sides are the plain version: equal results pass, a
    swap of two new keys inside one bucket (what K3 may do) passes, and
    a key moved to another slot of the chunk fails."""
    import chip_smoke
    rng = np.random.default_rng(1)
    C = 256
    before = pht.HashTable.empty(C, [torch.int64], "cpu")
    pht.lookup_or_insert_plain(before, [torch.arange(40) * 3],
                               torch.ones(40, dtype=torch.bool))
    keys = [torch.from_numpy(rng.integers(0, 200, 300))]
    act = torch.ones(300, dtype=torch.bool)

    def run():
        t = pht.HashTable(tuple(k.clone() for k in before.keys),
                          before.occupied.clone())
        _, s, n = pht.lookup_or_insert_plain(t, keys, act)
        return t, s, n

    ta, sa, na = run()
    tb, sb, nb = run()
    chip_smoke.k3_invariants(before, keys, act, sa, na, ta, sb, nb, tb)
    # swap two new keys that share a bucket
    new_slots = sa[before.occupied[sa.long()].logical_not()].unique()
    by_bucket = {}
    for s in new_slots.tolist():
        by_bucket.setdefault(s // pht.BUCKET_SLOTS, []).append(s)
    x, y = next(v for v in by_bucket.values() if len(v) >= 2)[:2]
    tk = ta.keys[0].clone()
    tk[x], tk[y] = ta.keys[0][y], ta.keys[0][x]
    swapped = pht.HashTable((tk,), ta.occupied.clone())
    ss = torch.where(sa == x, y, torch.where(sa == y, x, sa)).to(torch.int32)
    chip_smoke.k3_invariants(before, keys, act, ss, na, swapped, sb, nb, tb)
    # a row sent to a slot that is not its key's
    bad = sa.clone()
    bad[0] = (int(sa[0]) + 1) % C
    with pytest.raises(AssertionError):
        chip_smoke.k3_invariants(before, keys, act, bad, na, ta, sb, nb, tb)
