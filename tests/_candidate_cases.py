"""Synthetic score maps and masks for the candidate lists and the refine,
shared by the CPU tests (``test_torch_candidates.py``,
``test_torch_refine.py``) and the card's (``test_torch_gpu.py``). numpy
only: the card's tests import no JAX.

Each case is three layers of two frames, (scores, masks, caps): maps no
Harris frame gives, at odd sizes, with caps below, at and above what
survives. A survivor is a masked-in pixel above the sentinel (INT32_MIN,
or -inf on float scores).

* ``all_masked_out``: no mask bit; every slot is a sentinel fill;
* ``no_survivor``: every pixel masked in at the sentinel itself, so the
  fills are valid;
* ``over_cap``: survivors far past the cap (the kernel's radix select),
  and between the cap and its power of two;
* ``whole_map``: k = h*w on every layer, the whole map ordered;
* ``ties``: three score values over the whole map;
* ``int32_min_masked_in``: masked-in INT32_MIN among ordinary scores;
* ``signed_zero``: float scores of -0.0, +0.0, -inf and a few others;
* ``float_spread``: float scores from 1e-12 to 1e12, both signs (the
  refine's products stay finite);
* ``signed_nan``: float scores among them masked-in NaNs with the sign
  set, which the total order puts under -inf, so after every pixel at the
  sentinel, each keeping its own bits; caps of the whole map and two
  short of it (some of them cut), and a map of them nearly all, more than
  its list holds (the kernel's radix select on them). The lists only:
  no Harris map holds a NaN, and the refine cases leave this one out;
* ``large_map``: one (1, 180, 200) layer of 50 score values, nearly all
  masked in, k = h*w: ~35,000 survivors, past a CTA's shared memory at
  small clusters (the kernel's device route);
* ``tie_runs``: long runs of equal scores that the cap cuts, across the
  kernel's slices: a flat map of which every pixel survives at a tenth of
  it (the radix select takes the first ties in flat order) and one masked
  in at random; bright boxes on a flat ground, every pixel in, the cap
  past the boxes into the ground; rows of three values in long runs.

The refine's own case (``REFINE_ONLY``):

* ``long_list``: a (2, 150, 230) layer, every pixel masked in, k = h*w =
  34,500: each frame's list past two of the refine kernel's chunks of
  16,384 flags, the second frame's row starting 4 bytes into a 16-byte
  word; and a (2, 9, 13) layer of one chunk. ``refine_caps`` gives it caps
  of 64, one past a chunk's slot table, half and the whole list.

Accept kinds (``ACCEPT_KINDS``) for the refine: none, every one, a seeded
half of the valid ones, and ``tail``: a seeded half of the last 1,024 flags
of each list and no other (the walk of a cut list must reach its end).
"""
import numpy as np

INT32_MIN = -(2**31)
KINDS = ("all_masked_out", "no_survivor", "over_cap", "whole_map", "ties",
         "int32_min_masked_in", "signed_zero", "float_spread", "large_map", "signed_nan",
         "tie_runs")
# The cases the refine tests leave out: one for its size, one because no
# Harris map holds a NaN, one whose point is the lists' tie order.
LISTS_ONLY = ("large_map", "signed_nan", "tie_runs")
REFINE_ONLY = ("long_list",)
REFINE_KINDS = tuple(k for k in KINDS if k not in LISTS_ONLY) + REFINE_ONLY
ACCEPT_KINDS = ("none", "all", "half", "tail")
TAIL = 1024
# Float32 bit patterns of the ``signed_nan`` maps: NaNs with the sign set
# (under -inf in the total order), -inf, +NaN, 1.0, +0.0 and -0.0.
NAN_BITS = (0xFFC00000, 0xFF800001, 0xFFFFFFFF, 0xFF800000, 0x7FC00000, 0x3F800000, 0, 0x80000000)
SHAPES = ((37, 45), (20, 31), (9, 13))


def case(kind: str):
    """(scores, masks, caps): lists of (B, h, w) int32 or float32 maps,
    (B, h, w) bool masks and a cap a layer."""
    rng = np.random.default_rng((KINDS + REFINE_ONLY).index(kind) + 11)
    if kind == "long_list":
        return ([rng.integers(-1000, 1000, (2, 150, 230)).astype(np.int32),
                 rng.integers(-1000, 1000, (2, 9, 13)).astype(np.int32)],
                [np.ones((2, 150, 230), bool), np.ones((2, 9, 13), bool)], [150 * 230, 9 * 13])
    if kind == "large_map":
        return ([rng.integers(0, 50, (1, 180, 200)).astype(np.int32)],
                [rng.random((1, 180, 200)) < 0.97], [180 * 200])
    scores, masks, caps = [], [], []
    for h, w in SHAPES:
        n = h * w
        shape = (2, h, w)
        mask = rng.random(shape) < 0.3
        s = rng.integers(-1000, 1000, shape).astype(np.int32)
        cap = n // 3
        if kind == "all_masked_out":
            mask[:] = False
        elif kind == "no_survivor":
            mask[:] = True
            s[:] = INT32_MIN
        elif kind == "over_cap":
            mask = rng.random(shape) < 0.8
            cap = {37: 5, 20: 3, 9: 60}[h]
            if h == 9:  # 62 survivors a frame: past the cap, within its power of two
                mask[:] = False
                for f in range(2):
                    mask[f].reshape(-1)[rng.choice(n, 62, replace=False)] = True
        elif kind == "whole_map":
            cap = n + 5
        elif kind == "ties":
            s = rng.choice(np.array([-4, 9, 9, 9, 30], np.int32), shape)
            mask = rng.random(shape) < 0.6
            cap = n // 2
        elif kind == "int32_min_masked_in":
            s = np.where(rng.random(shape) < 0.4, INT32_MIN,
                         rng.integers(-(2**31) + 1, 2**31, shape)).astype(np.int32)
            mask = rng.random(shape) < 0.7
            cap = n - 3
        elif kind == "signed_zero":
            s = rng.choice(np.array([-0.0, 0.0, -np.inf, 2.5, -1.0], np.float32), shape)
            mask = rng.random(shape) < 0.6
            cap = n // 2
        elif kind == "signed_nan":
            s = rng.choice(np.array(NAN_BITS, np.uint32), shape).view(np.float32)
            mask = rng.random(shape) < 0.7
            cap = {37: n, 20: n - 2, 9: n // 3}[h]
            if h == 9:  # every pixel masked in, ~90 % signed NaNs: more than the list holds
                s = rng.choice(np.array(NAN_BITS[:3] + NAN_BITS[5:6], np.uint32), shape,
                               p=[0.3, 0.3, 0.3, 0.1]).view(np.float32)
                mask[:] = True
        elif kind == "tie_runs":
            if h == 37:  # flat: frame 0 every pixel in, frame 1 most of them
                s[:] = 7
                mask[0] = True
                mask[1] = rng.random((h, w)) < 0.9
                cap = n // 10
            elif h == 20:  # boxes of 50 on a ground of 3, every pixel in
                s[:] = 3
                s[:, 4:9, 6:20] = 50
                s[1, 12:18, 2:7] = 50
                mask[:] = True
                cap = int((s[0] == 50).sum()) + n // 10
            else:  # rows of three values in long runs
                s = np.repeat(np.array([5, -2, 5], np.int32)[rng.integers(0, 3, (2, h, 1))],
                              w, axis=2)
                mask = rng.random(shape) < 0.9
                cap = n // 3
        elif kind == "float_spread":
            s = rng.standard_normal(shape) * 10.0 ** rng.integers(-12, 12, shape)
            s = s.astype(np.float32)
            mask = rng.random(shape) < 0.5
            cap = n // 4
        scores.append(s)
        masks.append(mask)
        caps.append(cap)
    return scores, masks, caps


def accepts_for(cands_valid, kind: str, seed: int = 0):
    """Accept flags (B, k) of one layer's candidates for the refine cases:
    none, every one, a seeded half of the valid ones, or (``tail``) a
    seeded half of the last ``TAIL`` flags."""
    rng = np.random.default_rng(seed)
    if kind == "none":
        return np.zeros(cands_valid.shape, bool)
    if kind == "all":
        return np.ones(cands_valid.shape, bool)
    if kind == "tail":
        acc = np.zeros(cands_valid.shape, bool)
        tail = acc[:, -TAIL:]
        tail[:] = rng.random(tail.shape) < 0.5
        return acc
    return cands_valid & (rng.random(cands_valid.shape) < 0.5)


def refine_caps(kind: str, k: int, chunk: int) -> list[int]:
    """A layer's refine caps for a case whose list holds k: k (no
    compaction), k / 2 and 3; for ``long_list`` k, k / 2, 64 and one past
    the refine kernel's slot table of ``chunk`` entries."""
    if kind == "long_list":
        return [k, k // 2, min(k, 64), min(k, chunk + 1)]
    return [k, k // 2, min(k, 3)]
