"""Synthetic Harris score maps for the candidate masks, shared by the CPU
tests (``test_torch_masks.py``) and the card's (``test_torch_gpu.py``).
numpy only: the card's tests import no JAX.

Maps that no Harris frame gives: int32 values at both ends of the range
(the int64 sums; the fill outside the map, INT32_MIN in the plain version
and 0 in the kernel and its twin), a few values with wide ties, and
all-negative maps (every 3-D check then decided by the zero fill), over
4 layers of a 53 x 67 frame pair."""
import numpy as np

KINDS = ("extremes", "ties", "negative")
THRESHOLDS = (-(2**31), 0, 5)
SHAPES = ((53, 67), (35, 44), (26, 33), (17, 22))


def synthetic_scores(kind: str) -> list[np.ndarray]:
    """The int32 (2, h, w) score map of each layer of ``SHAPES``."""
    rng = np.random.default_rng({"extremes": 1, "ties": 2, "negative": 3}[kind])
    scores = []
    for h, w in SHAPES:
        if kind == "extremes":
            s = rng.integers(-(2**31), 2**31, (2, h, w), dtype=np.int64)
            s[:, ::5, ::7] = rng.choice([-(2**31), 2**31 - 1], (2, len(range(0, h, 5)),
                                                                len(range(0, w, 7))))
        elif kind == "ties":
            s = rng.choice([-3, 0, 5, 5, 5, 9], (2, h, w))
        else:
            s = -rng.integers(1, 2**30, (2, h, w), dtype=np.int64)
            s[:, h // 2, w // 2] = -1
        scores.append(s.astype(np.int32))
    return scores
