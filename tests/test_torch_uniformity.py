"""Port parity: greedy uniformity's plain forms against the JAX package.

``enforce_uniformity_scan_plain`` (kernel ``enforce_uniformity``'s rounds
in torch) and ``enforce_uniformity_plain`` (the blocked form) are held bit
for bit against the JAX ``enforce_uniformity_sequential`` (the reference's
greedy loop) and the JAX blocked ``enforce_uniformity``, both jitted on the
CPU as the JAX tests run them, on numpy-seeded candidates: the radii 10,
19, 30 and 45, caps 40, 1 and none, int32 and float32 scores, a problem
with no valid candidate and one whose first is invalid, cells on the
layer's border, duplicate cells, a window that straddles an accept, and a
problem with more candidates than the kernel keeps in shared memory (its
device-memory route; here at the twin's arithmetic). The kernel's launch
layout is read from ``csrc/uniformity.cu``. (``detect_keypoints``' accept
masks and accepted counts against the JAX detection:
``test_torch_pipeline.py``, on its step's frames.)
"""
import pathlib
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.detect.uniformity import (  # noqa: E402
    enforce_uniformity as jax_blocked,
    enforce_uniformity_sequential as jax_sequential,
)
from ethzasl_brisk_tpu_torch.detect import uniformity as tu  # noqa: E402
from tests._uniformity_cases import CASES, case  # noqa: E402

@pytest.mark.parametrize("name", CASES)
def test_uniformity_plain_forms_match_jax(name):
    xs, ys, scores, valid, rows, cols, radius, cap = case(name)
    args = [torch.from_numpy(a) for a in (xs, ys, scores, valid)]
    scan = tu.enforce_uniformity_scan_plain(*args, radius=radius, max_num_kpt=cap).numpy()
    blocked = tu.enforce_uniformity_plain(*args, radius=radius, max_num_kpt=cap).numpy()
    kw = dict(rows=rows, cols=cols, radius=radius, max_num_kpt=cap)
    for r in range(xs.shape[0]):
        row = [jnp.asarray(a[r]) for a in (xs, ys, scores, valid)]
        ref = np.asarray(jax_sequential(*row, **kw))
        np.testing.assert_array_equal(scan[r], ref, err_msg=f"scan twin, row {r}")
        np.testing.assert_array_equal(blocked[r], ref, err_msg=f"blocked, row {r}")
        if xs.shape[1] <= 1000:  # the blocked JAX form compiles per shape
            np.testing.assert_array_equal(np.asarray(jax_blocked(*row, **kw)), ref,
                                          err_msg=f"JAX blocked, row {r}")
        assert ref.sum() <= min(cap, valid[r].sum())
        assert not (ref & ~valid[r]).any()
    if name == "no_valid_first_invalid":
        assert not scan[0].any() and not scan[1, 0] and scan[1].any()
    if name == "straddle":
        t = tu.WINDOW
        assert scan[0, 0] and scan[0, t - 2] and scan[0, t + 4]
        assert not scan[0, 1 : t - 2].any() and not scan[0, t - 1 : t + 4].any()
    if name == "r30_int_cap1":
        assert scan.sum(axis=1).tolist() == [1, 1]
    if name == "beyond_shared_memory":
        assert xs.shape[1] > tu.MAX_SHARED_CANDIDATES and scan.sum() > 100


def test_scan_twin_matches_window_sizes():
    """The rounds' window is a schedule, not a semantics: the twin at the
    kernel's window and at windows of 1 and 37 gives one mask."""
    xs, ys, scores, valid, *_ , radius, cap = case("r10_int_uncapped")
    args = [torch.from_numpy(a) for a in (xs, ys, scores, valid)]
    ref = tu.enforce_uniformity_scan_plain(*args, radius=radius, max_num_kpt=cap)
    for window in (1, 37):
        got = tu.enforce_uniformity_scan_plain(*args, radius=radius, max_num_kpt=cap,
                                               window=window)
        assert torch.equal(got, ref), window


def test_kernel_layout_matches_the_source():
    """WINDOW, MAX_LAYERS and MAX_SHARED_CANDIDATES are csrc/uniformity.cu's
    kThreads, kMaxLayers and kMaxSharedCandidates; the largest shared-memory
    problem fits a CTA's 227 KB."""
    src = (pathlib.Path(tu.__file__).parents[1] / "csrc" / "uniformity.cu").read_text()
    const = {m[0]: m[1] for m in re.findall(r"constexpr int (k\w+) = ([^;]+);", src)}
    assert int(const["kThreads"]) == tu.WINDOW
    assert int(const["kMaxLayers"]) == tu.MAX_LAYERS
    assert int(const["kMaxShared"]) == 232448
    assert int(const["kSharedBytesPerCandidate"]) == 9
    fixed = 31 * 31 * 4 + 2 * (tu.WINDOW // 32) * 4
    assert tu.MAX_SHARED_CANDIDATES == (232448 - fixed) // 9
    assert fixed + 9 * tu.MAX_SHARED_CANDIDATES <= 232448


def test_cuda_wrapper_refuses_cpu_tensors():
    xs, ys, scores, valid, *_ = case("r30_int_cap1")
    args = tuple(torch.from_numpy(a) for a in (xs, ys, scores, valid))
    with pytest.raises(ValueError, match="CUDA"):
        tu.enforce_uniformity_cuda([(*args, 5)], radius=30.0)
