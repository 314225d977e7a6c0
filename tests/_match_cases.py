"""Descriptor words for the adjacent-frame match, shared by the CPU tests
(``test_torch_match_adjacent.py``) and the card's (``test_torch_gpu.py``).
numpy only: the card's tests import no JAX.

Each case is a (B, K, W) batch of uint32 words with duplicated rows (ties
at distance 0 and above, which go to the lowest train index), invalid
slots, and the rules the kernel must keep: a train frame with no valid
slot, invalid queries (which keep their real best index), 16-word (v1)
descriptors, K = 1, K not a multiple of 32, B = 1 and 2."""
import numpy as np

CASES = ("ties", "no_valid_train", "invalid_queries", "w16", "k1", "k130", "b1", "b2_k31")
SHAPES = {"ties": (4, 40, 12), "no_valid_train": (3, 45, 12), "invalid_queries": (3, 64, 12),
          "w16": (3, 37, 16), "k1": (4, 1, 12), "k130": (3, 130, 12), "b1": (1, 33, 12),
          "b2_k31": (2, 31, 16)}


def words(rng, b, k, w, dup_every=3):
    """(b, k, w) uint32 words; in each frame every ``dup_every``-th row
    repeats an earlier one, and every frame after the first copies a few of
    the frame before's rows, half of them with two bits flipped."""
    d = rng.integers(0, 2**32, (b, k, w), dtype=np.uint64).astype(np.uint32)
    for f in range(b):
        for i in range(dup_every, k, dup_every):
            d[f, i] = d[f, rng.integers(0, i)]
        if f and k > 2:
            rows = rng.integers(0, k, max(1, k // 4))
            d[f, rows] = d[f - 1, rng.integers(0, k, rows.size)]
            d[f, rows[: rows.size // 2], 0] ^= np.uint32(0b1001)
    return d


def case(name):
    """(words (B, K, W) uint32, valid (B, K) bool) of a named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    b, k, w = SHAPES[name]
    d = words(rng, b, k, w)
    valid = rng.random((b, k)) > 0.25
    if name == "no_valid_train":
        valid[0] = False  # pair 0's train frame
        valid[2, : k // 2] = False
    if name == "invalid_queries":
        valid[1:, ::2] = False
    if name == "k1":
        valid[:, 0] = [True, False, True, True]
    return d, valid


def step_case(b, k, w, seed):
    """A step's shapes: (b, k, w) words with duplicates and ~60 % valid slots,
    the rest of each frame invalid as a step's unfilled slots are."""
    rng = np.random.default_rng(seed)
    d = words(rng, b, k, w, dup_every=7)
    valid = rng.random((b, k)) > 0.1
    valid[:, (6 * k) // 10 :] = False
    return d, valid
