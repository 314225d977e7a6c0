"""Port parity: greedy uniformity's plain forms against the JAX package.

``enforce_uniformity_grid_plain`` and ``enforce_uniformity_scan_plain``
(kernel ``enforce_uniformity``'s grid and candidates routes in torch) and
``enforce_uniformity_plain`` (the blocked form) are held bit for bit
against the JAX ``enforce_uniformity_sequential`` (the reference's greedy
loop) and the JAX blocked ``enforce_uniformity``, both jitted on the CPU as
the JAX tests run them, on numpy-seeded candidates: the radii 10, 19, 30
and 45, caps 40, 1 and none, int32 and float32 scores, int32 scores above
2^24, a problem with no valid candidate and one whose first is invalid,
cells on the layer's border, duplicate cells, a window that straddles an
accept, a problem with more candidates than the kernel keeps in shared
memory (its device-memory staging; here at the twins' arithmetic), and a
radius-10 VGA layer whose grid exceeds shared memory (the candidates
route). The kernel's launch layout and the routes' thresholds are read
from ``csrc/uniformity.cu``. (``detect_keypoints``' accept
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
    grid = tu.enforce_uniformity_grid_plain(*args, rows=rows, cols=cols, radius=radius,
                                            max_num_kpt=cap).numpy()
    blocked = tu.enforce_uniformity_plain(*args, radius=radius, max_num_kpt=cap).numpy()
    kw = dict(rows=rows, cols=cols, radius=radius, max_num_kpt=cap)
    for r in range(xs.shape[0]):
        row = [jnp.asarray(a[r]) for a in (xs, ys, scores, valid)]
        ref = np.asarray(jax_sequential(*row, **kw))
        np.testing.assert_array_equal(scan[r], ref, err_msg=f"scan twin, row {r}")
        np.testing.assert_array_equal(grid[r], ref, err_msg=f"grid twin, row {r}")
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


def test_grid_twin_matches_window_sizes():
    """The grid twin's window is a schedule too: windows of 1, 37 and the
    kernel's give one mask, which is the scan twin's."""
    xs, ys, scores, valid, rows, cols, radius, cap = case("border_duplicates")
    args = [torch.from_numpy(a) for a in (xs, ys, scores, valid)]
    kw = dict(rows=rows, cols=cols, radius=radius, max_num_kpt=cap)
    ref = tu.enforce_uniformity_grid_plain(*args, **kw)
    assert torch.equal(ref, tu.enforce_uniformity_scan_plain(*args, radius=radius,
                                                             max_num_kpt=cap))
    for window in (1, 37):
        assert torch.equal(tu.enforce_uniformity_grid_plain(*args, **kw, window=window), ref)


@pytest.mark.parametrize("name", CASES)
def test_grid_extent_covers_every_patch(name):
    """``grid_shape`` holds every valid candidate's whole 31x31 patch: the
    cells of the layer's corners and of every case's candidates lie at
    least 15 from each edge, and the last row and column are reached."""
    xs, ys, scores, valid, rows, cols, radius, _ = case(name)
    gh, gw = tu.grid_shape(rows, cols, radius)
    corner_x = torch.tensor([[0, cols - 1]], dtype=torch.int32)
    corner_y = torch.tensor([[0, rows - 1]], dtype=torch.int32)
    _, cx, cy = tu._cells(corner_x, corner_y, torch.ones((1, 2)), torch.ones((1, 2), dtype=bool),
                          radius)
    assert cx.tolist() == [[16, gw - 16]] and cy.tolist() == [[16, gh - 16]]
    args = [torch.from_numpy(a) for a in (xs, ys, scores, valid)]
    _, cx, cy = tu._cells(*args, radius)
    v = args[3]
    assert bool(((cx[v] >= 15) & (cx[v] <= gw - 16) & (cy[v] >= 15) & (cy[v] <= gh - 16)).all())


def test_layer_plan_routes():
    """Routes and shared memory from Python ints: the B=16 step's four VGA
    layers at radius 30 take the grid with their candidates staged behind
    it; a radius-10 VGA layer's grid exceeds a CTA's shared memory and
    takes the candidates route, as does a layer given no shape and one
    asked for it; a K past the grid's room stages in device memory, as
    "device" staging asks; an unknown route or staging is refused."""
    step = [((480, 640), 10240), ((320, 427), 3072), ((240, 320), 3072), ((160, 213), 1024)]
    for shape, k in step:
        route, gh, gw, shared, nbytes = tu.layer_plan(k, shape, 30.0)
        assert route == "grid" and shared and nbytes <= tu.MAX_SHARED
        assert nbytes == tu.GRID_FIXED_SHARED + -(-gh * gw // 16) * 16 + 8 * k
    assert tu.layer_plan(10240, (480, 640), 30.0)[1:3] == (271, 351)
    route, gh, gw, _, _ = tu.layer_plan(600, (480, 640), 10.0)
    assert route == "candidates" and (gh, gw) == (0, 0)
    assert tu.grid_shape(480, 640, 10.0) == (750, 990) and 750 * 990 > tu.MAX_GRID_BYTES
    assert tu.layer_plan(600, None, 30.0)[0] == "candidates"
    assert tu.layer_plan(600, (480, 640), 30.0, route="candidates")[0] == "candidates"
    k = tu.MAX_SHARED_CANDIDATES + 100
    assert tu.layer_plan(k, (480, 640), 30.0) == ("grid", 271, 351, False,
                                                  tu.GRID_FIXED_SHARED + 95136)
    assert tu.layer_plan(k, None, 30.0) == ("candidates", 0, 0, False, tu.FIXED_SHARED)
    assert tu.layer_plan(10240, (480, 640), 30.0, staging="device")[3:] == (
        False, tu.GRID_FIXED_SHARED + 95136)
    with pytest.raises(ValueError, match="route"):
        tu.layer_plan(600, (480, 640), 30.0, route="grid")
    with pytest.raises(ValueError, match="staging"):
        tu.layer_plan(600, (480, 640), 30.0, staging="auto")
    with pytest.raises(ValueError, match="staging"):
        tu.layer_plan(600, (480, 640), 30.0, staging="global")


def test_kernel_layout_matches_the_source():
    """WINDOW, MAX_LAYERS, MAX_SHARED_CANDIDATES and the grid route's
    constants are csrc/uniformity.cu's: kThreads, kMaxLayers, the
    candidates route's shared layout, the grid's fixed shared bytes, its
    staged bytes a candidate, the route threshold kMaxGridBytes and the
    scratch's bytes a candidate; the largest shared-memory problem of each
    route fits a CTA's 227 KB."""
    src = (pathlib.Path(tu.__file__).parents[1] / "csrc" / "uniformity.cu").read_text()
    const = {}
    for name, expr in re.findall(r"constexpr int (k\w+) = ([^;]+);", src):
        # each in terms of the ones before it, in C's integer arithmetic
        const[name] = eval(expr.replace("/", "//"), {}, dict(const))
    assert const["kThreads"] == tu.WINDOW
    assert const["kMaxLayers"] == tu.MAX_LAYERS
    assert const["kMaxShared"] == tu.MAX_SHARED == 232448
    assert const["kFixedShared"] == tu.FIXED_SHARED == 31 * 31 * 4 + 2 * (tu.WINDOW // 32) * 4
    assert const["kSharedBytesPerCandidate"] == tu.SHARED_BYTES_PER_CANDIDATE == 13
    assert const["kMaxSharedCandidates"] == tu.MAX_SHARED_CANDIDATES
    assert tu.MAX_SHARED_CANDIDATES == (232448 - tu.FIXED_SHARED) // 13
    assert tu.FIXED_SHARED + 13 * tu.MAX_SHARED_CANDIDATES <= 232448
    assert const["kGridFixedShared"] == tu.GRID_FIXED_SHARED == -(-24 * (tu.WINDOW // 32) // 16) * 16
    assert tu.GRID_FIXED_SHARED % 16 == 0  # the grid's 16-byte stores
    assert const["kGridStagedBytesPerCandidate"] == tu.GRID_STAGED_BYTES_PER_CANDIDATE == 8
    assert const["kMaxGridBytes"] == tu.MAX_GRID_BYTES == 232448 - tu.GRID_FIXED_SHARED
    assert const["kScratchBytesPerCandidate"] == tu.SCRATCH_BYTES_PER_CANDIDATE == 13
    assert const["kFields"] == 12


def test_cuda_wrapper_refuses_cpu_tensors():
    xs, ys, scores, valid, *_ = case("r30_int_cap1")
    args = tuple(torch.from_numpy(a) for a in (xs, ys, scores, valid))
    with pytest.raises(ValueError, match="CUDA"):
        tu.enforce_uniformity_cuda([(*args, 5)], radius=30.0)
