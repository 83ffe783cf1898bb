"""The plain versions of kernels K11 (stable sort, ops/sort.py) and K12
(mask compaction, ops/hash_table.py) against the JAX package's
jnp.argsort(stable=True), stable_lexsort and compact_mask, on seeded
numpy inputs: ties, negative and extreme int64, bounded keys of the
widths the kernel's key_bits covers, all-false and all-true masks.
Compared exactly. (The kernels themselves run only on the card:
chip_smoke.py's kernels_q8 phase holds them against these.)"""

import jax.numpy as jnp
import numpy as np
import pytest

from risingwave_tpu.ops.hash_table import (
    compact_mask as jax_compact, stable_lexsort as jax_lexsort,
)

I64_MIN, I64_MAX = np.iinfo(np.int64).min, np.iinfo(np.int64).max


@pytest.fixture(autouse=True, scope="module")
def _port():
    """Import torch and the port when these tests run, not at collection:
    an xdist worker then runs the JAX tests before them without torch
    (the sharded-join recovery tests abort more often with it loaded)."""
    global torch, sort, ht
    import torch
    from risingwave_tpu_torch.ops import hash_table as ht
    from risingwave_tpu_torch.ops import sort


def _keys(case: str, n: int, rng) -> np.ndarray:
    if case == "ties":
        return rng.integers(-5, 5, n, dtype=np.int64)
    if case == "extreme":
        return rng.choice(np.array([I64_MIN, I64_MAX, 0, -1, 1,
                                    I64_MIN + 1, I64_MAX - 1]), n)
    if case == "hash63":
        return rng.integers(0, I64_MAX, n, dtype=np.int64, endpoint=True)
    if case == "wide":
        return rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64,
                            endpoint=True)
    if case == "flag":
        return rng.integers(0, 2, n, dtype=np.int64)
    raise ValueError(case)


CASES = [("ties", 5000), ("extreme", 3000), ("hash63", 4097),
         ("wide", 2048), ("flag", 777), ("ties", 1), ("wide", 0)]


@pytest.mark.parametrize("case,n", CASES)
def test_stable_sort_plain_matches_jax_argsort(case, n):
    rng = np.random.default_rng(hash((case, n)) % 2**32)
    keys = _keys(case, n, rng)
    s, perm = sort.stable_sort(torch.from_numpy(keys))
    want = np.asarray(jnp.argsort(jnp.asarray(keys), stable=True))
    assert np.array_equal(perm.numpy(), want)
    assert np.array_equal(s.numpy(), keys[want])
    # the values form permutes the given values by the same order
    vals = rng.permutation(n).astype(np.int64)
    s2, v2 = sort.stable_sort(torch.from_numpy(keys), 64,
                              torch.from_numpy(vals))
    assert np.array_equal(v2.numpy(), vals[want])
    assert np.array_equal(s2.numpy(), s.numpy())


def test_stable_lexsort_plain_matches_jax():
    rng = np.random.default_rng(7)
    n = 16384
    cases = [
        # the netting lexsort: a pk with runs, then the NULL-key flag
        [rng.integers(0, n // 4, n, dtype=np.int64),
         rng.integers(0, 2, n).astype(np.uint8)],
        # K3's plain sort 1: two key columns, then the miss flag
        [_keys("extreme", n, rng), rng.integers(-3, 3, n).astype(np.int32),
         rng.integers(0, 2, n).astype(np.uint8)],
        [_keys("ties", n, rng)],
    ]
    for keys in cases:
        got = sort.stable_lexsort([torch.from_numpy(k) for k in keys])
        want = np.asarray(jax_lexsort([jnp.asarray(k) for k in keys]))
        assert np.array_equal(got.numpy(), want)


def test_key_bits_of_covers_the_lexsort_key_types():
    assert sort.key_bits_of(torch.zeros(2, dtype=torch.bool)) == 1
    assert sort.key_bits_of(torch.zeros(2, dtype=torch.uint8)) == 8
    for dt in (torch.int8, torch.int32, torch.int64):
        assert sort.key_bits_of(torch.zeros(2, dtype=dt)) == 64


@pytest.mark.parametrize("density,n", [(0.3, 1 << 16), (0.0, 4096),
                                       (1.0, 4096), (0.5, 1000003),
                                       (0.01, 257), (1.0, 1)])
def test_compact_mask_plain_matches_jax(density, n):
    rng = np.random.default_rng(int(density * 100) + n)
    mask = rng.random(n) < density
    sel, cnt = ht.compact_mask(torch.from_numpy(mask))
    jsel, jcnt = jax_compact(jnp.asarray(mask))
    assert int(cnt) == int(jcnt) == int(mask.sum())
    assert np.array_equal(sel.numpy(), np.asarray(jsel).astype(np.int64))
    assert sel.dtype == torch.int64 and cnt.dtype == torch.int64
    assert np.array_equal(sel.numpy()[:int(cnt)], np.flatnonzero(mask))
    assert not sel.numpy()[int(cnt):].any()


def test_kernel_wrappers_refuse_other_devices_and_bad_input():
    meta = torch.zeros(8, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sort.stable_sort(meta)
    with pytest.raises(ValueError, match="unsupported device"):
        ht.compact_mask(torch.zeros(8, dtype=torch.bool, device="meta"))
