"""Greedy uniformity's test problems, shared by the CPU parity tests
(``test_torch_uniformity.py``) and the card's (``test_torch_gpu.py``).
numpy only: the card's tests import no JAX."""
import numpy as np

from ethzasl_brisk_tpu_torch.detect import uniformity as tu

UNCAPPED = 2**31 - 1
INT32_MIN = np.iinfo(np.int32).min


def _candidates(rng, n, k, rows, cols, dtype, n_valid):
    """Score-descending candidates, the first ``n_valid[r]`` of row r valid
    and the rest masked as the detector masks them."""
    xs = rng.integers(0, cols, (n, k)).astype(np.int32)
    ys = rng.integers(0, rows, (n, k)).astype(np.int32)
    if dtype == np.int32:
        scores = -np.sort(-rng.integers(20, 5000, (n, k)), axis=1).astype(np.int32)
        low = INT32_MIN
    else:
        scores = -np.sort(-rng.uniform(1e6, 3e9, (n, k)), axis=1).astype(np.float32)
        low = -np.inf
    valid = np.arange(k)[None, :] < np.asarray(n_valid)[:, None]
    return xs, ys, np.where(valid, scores, low).astype(dtype), valid


def case(name):
    """(xs, ys, scores, valid, rows, cols, radius, cap) of one case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "r10_int_uncapped":
        return (*_candidates(rng, 3, 600, 120, 160, np.int32, [600, 450, 200]), 120, 160, 10.0,
                UNCAPPED)
    if name == "r19_f32_cap40":
        return (*_candidates(rng, 3, 600, 120, 160, np.float32, [600, 600, 300]), 120, 160,
                19.0, 40)
    if name == "r30_int_cap1":
        return (*_candidates(rng, 2, 300, 120, 160, np.int32, [300, 100]), 120, 160, 30.0, 1)
    if name == "r45_f32_uncapped":
        return (*_candidates(rng, 2, 700, 240, 320, np.float32, [700, 650]), 240, 320, 45.0,
                UNCAPPED)
    if name == "no_valid_first_invalid":
        # Row 0 has no valid candidate; row 1's first candidate (the top
        # score) is invalid and the rest valid.
        xs, ys, scores, valid = _candidates(rng, 3, 600, 120, 160, np.int32, [0, 600, 600])
        scores[0] = INT32_MIN
        valid[1, 0] = False
        return xs, ys, scores, valid, 120, 160, 30.0, UNCAPPED
    if name == "border_duplicates":
        # Cells on the layer's edges and corners, and every cell taken by
        # several candidates.
        xs, ys, scores, valid = _candidates(rng, 2, 600, 120, 160, np.int32, [600, 580])
        edge = rng.integers(0, 4, (2, 600))
        xs = np.where(edge == 0, 0, np.where(edge == 1, 159, xs)).astype(np.int32)
        ys = np.where(edge == 2, 0, np.where(edge == 3, 119, ys)).astype(np.int32)
        pick = rng.integers(0, 40, (2, 600))
        return (np.take_along_axis(xs, pick, 1), np.take_along_axis(ys, pick, 1), scores,
                valid, 120, 160, 10.0, UNCAPPED)
    if name == "straddle":
        # Accepts at 0 and at WINDOW - 2: the window after the second
        # starts at WINDOW - 1, across the fixed windows' boundary, and
        # accepts again inside it.
        t = tu.WINDOW
        k = 3 * t + 7
        xs, ys, scores, valid = _candidates(rng, 1, k, 120, 160, np.int32, [k])
        xs[0, : t - 2], ys[0, : t - 2] = 80, 60            # all on candidate 0's cell
        xs[0, t - 2], ys[0, t - 2] = 5, 5                  # a free cell
        xs[0, t - 1 : t + 4], ys[0, t - 1 : t + 4] = 80, 60  # rejected again
        xs[0, t + 4], ys[0, t + 4] = 150, 110              # a free cell again
        # Candidate 0 paints 253 on its cell; the rest score under 1/3 of it
        # (nsc1 under 194), so its cell rejects them.
        scores[0, 0], scores[0, 1:] = 4000, 1200 - np.arange(k - 1) // 8
        return xs, ys, scores, valid, 120, 160, 30.0, UNCAPPED
    if name == "beyond_shared_memory":
        k = tu.MAX_SHARED_CANDIDATES + 100
        return (*_candidates(rng, 1, k, 480, 640, np.int32, [k - 50]), 480, 640, 30.0,
                UNCAPPED)
    if name == "int_above_2_24":
        # int32 scores from 2^24 to 2^31 - 1: their float32 conversion
        # rounds, so neighbouring scores share a float.
        xs, ys, _, valid = _candidates(rng, 2, 600, 120, 160, np.int32, [600, 520])
        scores = -np.sort(-rng.integers(2**24, 2**31 - 1, (2, 600)), axis=1).astype(np.int32)
        scores[:, 100:140] = scores[:, 100:101] - np.arange(40)  # a run one apart
        scores = np.where(valid, scores, INT32_MIN).astype(np.int32)
        return xs, ys, scores, valid, 120, 160, 19.0, UNCAPPED
    if name == "r10_vga_candidates":
        # Radius 10 on a VGA layer: the grid (750 x 990 bytes) exceeds a
        # CTA's shared memory, so the kernel takes the candidates route.
        return (*_candidates(rng, 2, 900, 480, 640, np.int32, [900, 700]), 480, 640, 10.0,
                UNCAPPED)
    raise KeyError(name)


CASES = ["r10_int_uncapped", "r19_f32_cap40", "r30_int_cap1", "r45_f32_uncapped",
         "no_valid_first_invalid", "border_duplicates", "straddle", "beyond_shared_memory",
         "int_above_2_24", "r10_vga_candidates"]
