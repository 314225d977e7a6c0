"""Port parity: every matcher function against the JAX package, bit for bit.

Descriptors come from numpy seeds with duplicated rows, so many distances
tie (the tie order is part of the contract: lower index first, image-major
in collections), and with invalid slots, pair masks and a three-image
collection, the cases of tests/test_matcher.py. The port's words are the
JAX package's uint32 words as int32 bit patterns.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.match import matcher as jm  # noqa: E402
from ethzasl_brisk_tpu_torch.match import matcher as tm  # noqa: E402

from .test_matcher import _hamming, _scalar_knn_collection  # noqa: E402


def _desc(rng, n, dup_every=3):
    """(n, 12) uint32 words; every ``dup_every``-th row repeats an earlier one."""
    d = rng.integers(0, 2**32, (n, 12), dtype=np.uint64).astype(np.uint32)
    for i in range(dup_every, n, dup_every):
        d[i] = d[rng.integers(0, i)]
    return d


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _eq(got, ref):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def case():
    """Query/train sets that share rows (ties at distance 0 and above)."""
    rng = np.random.default_rng(11)
    train = _desc(rng, 40)
    query = np.concatenate([train[rng.integers(0, 40, 10)], _desc(rng, 15)])
    # Flip a few bits so near-duplicates tie at small distances too.
    query[12:16, 0] ^= np.uint32(0b101)
    qv = rng.random(25) > 0.2
    tv = rng.random(40) > 0.25
    return query, train, qv, tv


def test_popcount_matrix_matches_jax(case):
    query, train, _, _ = case
    ref = jm.hamming_distance_matrix_popcnt(jnp.asarray(query), jnp.asarray(train))
    _eq(tm.hamming_distance_matrix_popcnt(_t(query), _t(train)), ref)
    _eq(tm.hamming_distance_matrix(_t(query), _t(train)), ref)
    np.testing.assert_array_equal(np.asarray(ref), _hamming(query, train))


@pytest.mark.parametrize("k", [1, 2, 5])
def test_knn_match_matches_jax(case, k):
    query, train, qv, tv = case
    ref = jm.knn_match(jnp.asarray(query), jnp.asarray(train), jnp.asarray(qv),
                       jnp.asarray(tv), k=k)
    got = tm.knn_match(_t(query), _t(train), _t(qv), _t(tv), k=k)
    for g, r in zip(got, ref):
        _eq(g, r)


@pytest.mark.parametrize("radius", [0, 1, 90, 400])
def test_radius_match_best_matches_jax(case, radius):
    query, train, qv, tv = case
    ref = jm.radius_match_best(jnp.asarray(query), jnp.asarray(train), jnp.asarray(qv),
                               jnp.asarray(tv), radius)
    got = tm.radius_match_best(_t(query), _t(train), _t(qv), _t(tv), radius)
    for g, r in zip(got, ref):
        _eq(g, r)


@pytest.mark.parametrize("max_distance,ratio", [(120, (8, 10)), (384, (1, 1))])
def test_ratio_crosscheck_matches_jax(case, max_distance, ratio):
    query, train, qv, tv = case
    ref = jm.match_with_ratio_and_crosscheck(
        jnp.asarray(query), jnp.asarray(train), jnp.asarray(qv), jnp.asarray(tv),
        max_distance, ratio_num=ratio[0], ratio_den=ratio[1],
    )
    got = tm.match_with_ratio_and_crosscheck(
        _t(query), _t(train), _t(qv), _t(tv), max_distance,
        ratio_num=ratio[0], ratio_den=ratio[1],
    )
    for g, r in zip(got, ref):
        _eq(g, r)
    assert int(got[1].sum()) > 0


def test_knn_match_masked_matches_jax(case):
    query, train, qv, tv = case
    mask = np.random.default_rng(12).random((25, 40)) > 0.4
    ref = jm.knn_match_masked(jnp.asarray(query), jnp.asarray(train), jnp.asarray(qv),
                              jnp.asarray(tv), jnp.asarray(mask), k=3)
    got = tm.knn_match_masked(_t(query), _t(train), _t(qv), _t(tv), _t(mask), k=3)
    for g, r in zip(got, ref):
        _eq(g, r)


@pytest.mark.parametrize("radius,max_matches", [(150, 6), (200, 40), (10, 4)])
def test_radius_match_all_matches_jax(case, radius, max_matches):
    query, train, qv, tv = case
    ref = jm.radius_match_all(jnp.asarray(query), jnp.asarray(train), jnp.asarray(qv),
                              jnp.asarray(tv), radius, max_matches=max_matches)
    got = tm.radius_match_all(_t(query), _t(train), _t(qv), _t(tv), radius,
                              max_matches=max_matches)
    for g, r in zip(got, ref):
        _eq(g, r)
    # True in-radius counts over the whole train set, not the returned slots.
    d = _hamming(query, train)
    want = ((d < radius) & tv[None, :]).sum(1)
    want[~qv] = 0
    np.testing.assert_array_equal(got[2].numpy(), want)


def test_radius_match_all_counts_past_capacity():
    q = np.zeros((3, 12), np.uint32)
    t = np.zeros((50, 12), np.uint32)
    idx, dist, counts = tm.radius_match_all(
        _t(q), _t(t), torch.ones(3, dtype=torch.bool), torch.ones(50, dtype=torch.bool),
        radius=10, max_matches=8,
    )
    np.testing.assert_array_equal(counts.numpy(), [50, 50, 50])
    assert tuple(dist.shape) == (3, 8) and bool((dist == 0).all())
    np.testing.assert_array_equal(idx.numpy(), np.tile(np.arange(8), (3, 1)))


@pytest.fixture(scope="module")
def collection_case():
    rng = np.random.default_rng(13)
    trains = [_desc(rng, 9), _desc(rng, 5), _desc(rng, 13)]
    # Image 2 repeats rows of image 0: cross-image ties go image-major.
    trains[2][:4] = trains[0][:4]
    query = np.concatenate([trains[0][:3], _desc(rng, 14)])
    valids = [rng.random(len(t)) > 0.2 for t in trains]
    masks = [rng.random((17, len(t))) > 0.3 for t in trains]
    return query, trains, valids, masks


def _collections(trains, valids):
    jc = jm.DescriptorCollection()
    tc = tm.DescriptorCollection()
    for t, v in zip(trains, valids):
        jc.add(jnp.asarray(t), None if v is None else jnp.asarray(v))
        tc.add(_t(t), None if v is None else _t(v))
    return jc, tc


@pytest.mark.parametrize("use_masks", [False, True])
def test_knn_collection_matches_jax(collection_case, use_masks):
    query, trains, valids, masks = collection_case
    jc, tc = _collections(trains, valids)
    assert tc.n_images == len(tc) == 3 and tc.sizes == jc.sizes
    qv = np.arange(17) != 5
    ref = jm.knn_match_collection(
        jnp.asarray(query), jc, jnp.asarray(qv),
        masks=[jnp.asarray(m) for m in masks] if use_masks else None, k=3,
    )
    got = tm.knn_match_collection(
        _t(query), tc, _t(qv), masks=[_t(m) for m in masks] if use_masks else None, k=3,
    )
    for g, r in zip(got, ref):
        _eq(g, r)


def test_knn_collection_matches_scalar_scan(collection_case):
    """All rows valid: the reference's image-major scan order, with ties."""
    query, trains, _, masks = collection_case
    _, tc = _collections(trains, [None] * 3)
    got = tm.knn_match_collection(_t(query), tc, masks=[_t(m) for m in masks], k=3)
    want = _scalar_knn_collection(query, trains, masks, k=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    tc.clear()
    assert len(tc) == 0


@pytest.mark.parametrize("use_masks", [False, True])
def test_radius_collection_matches_jax(collection_case, use_masks):
    query, trains, valids, masks = collection_case
    jc, tc = _collections(trains, valids)
    ref = jm.radius_match_collection(
        jnp.asarray(query), jc, 190,
        masks=[jnp.asarray(m) for m in masks] if use_masks else None, max_matches=5,
    )
    got = tm.radius_match_collection(
        _t(query), tc, 190, masks=[_t(m) for m in masks] if use_masks else None,
        max_matches=5,
    )
    for g, r in zip(got, ref):
        _eq(g, r)
    assert int(got[3].max()) > 5  # some rows overflow the capacity
