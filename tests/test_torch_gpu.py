"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA device and skips without one. This file
imports no JAX, so the card's machine runs it without the JAX package's
test configuration:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""
import numpy as np
import pytest
import torch

from ethzasl_brisk_tpu_torch import BriskFeature
from ethzasl_brisk_tpu_torch.core.pattern import brisk_v2_pattern
from ethzasl_brisk_tpu_torch.describe.extractor import _stack_frames, scale_index
from ethzasl_brisk_tpu_torch.describe.sampler import smoothed_intensity, smoothed_intensity_cuda
from ethzasl_brisk_tpu_torch.frames import bench_frames
from ethzasl_brisk_tpu_torch.kernels.harris import (
    harris_score_i32,
    harris_score_i32_cuda,
    harris_score_mask_cuda,
    harris_score_mask_i32,
    harris_score_mask_layers,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "shape", [(2, 480, 640), (3, 320, 426), (2, 240, 320), (2, 160, 213), (1, 37, 70), (1, 4, 5)]
)
def test_harris_cuda_matches_plain(cuda, shape):
    rng = np.random.default_rng(3)
    imgs = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(cuda)
    got = harris_score_i32_cuda(imgs)
    torch.cuda.synchronize()
    assert torch.equal(got, harris_score_i32(imgs))


@pytest.mark.parametrize("thr", [0, 20, 300])
@pytest.mark.parametrize(
    "shape", [(2, 480, 640), (3, 320, 426), (2, 240, 320), (2, 160, 213), (1, 37, 70), (1, 4, 5)]
)
def test_harris_mask_cuda_matches_plain(cuda, shape, thr):
    """Kernel K3 on smoothed noise (so the mask is not empty), scores and
    mask bit for bit; the mask's bytes are only 0 and 1."""
    imgs = torch.from_numpy(bench_frames(shape[0], shape[1], shape[2], seed=3)).to(cuda)
    got_sc, got_mask = harris_score_mask_cuda(imgs, thr)
    torch.cuda.synchronize()
    ref_sc, ref_mask = harris_score_mask_i32(imgs, thr)
    assert torch.equal(got_sc, ref_sc)
    assert torch.equal(got_mask, ref_mask)
    assert int(got_mask.view(torch.uint8).max()) <= 1
    if shape[1] >= 37:
        assert int(got_mask.sum()) > 0


@pytest.mark.parametrize("pattern_scale", [1.0, 0.3])
def test_sampler_cuda_matches_plain(cuda, pattern_scale):
    """Random keypoints, including ones whose pattern leaves the frame
    (clipped taps) and, at pattern_scale 0.3, small-sigma points."""
    rng = np.random.default_rng(1)
    b, h, w, k = 3, 120, 160, 200
    imgs = torch.from_numpy(bench_frames(b, h, w)).to(cuda)
    host = brisk_v2_pattern(pattern_scale)
    sizes = torch.from_numpy(rng.choice([12.0, 18.0, 24.0, 36.0, 54.0], b * k).astype(np.float32))
    sidx = scale_index(sizes).numpy()
    rot = rng.integers(0, 1024, b * k)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cuda)

    args = (
        _stack_frames(imgs),
        t(rng.uniform(-5, w + 5, b * k).astype(np.float32)),
        t(rng.uniform(-5, h + 5, b * k).astype(np.float32)),
        t(host.lut_x[sidx, rot]), t(host.lut_y[sidx, rot]), t(host.lut_sigma[sidx]),
        t(host.lut_scaling[sidx]), t(host.lut_scaling2[sidx]),
        t(np.repeat(np.arange(b, dtype=np.int32) * (h + 1), k)), h,
    )
    got = smoothed_intensity_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, smoothed_intensity(*args))


def test_harris_layers_cuda_one_launch(cuda):
    """K1 on layers of mixed widths in one launch (the main path's four
    VGA layers, odd and tiny ones), and nine layers in two launches (the
    layer table holds eight); every layer bitwise equal to plain."""
    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.kernels.harris import harris_score_i32_layers

    rng = np.random.default_rng(4)
    shapes = [(2, 480, 640), (2, 320, 426), (2, 240, 320), (2, 160, 213)]
    for extra in ([], [(1, 37, 70), (3, 4, 5), (1, 41, 121), (2, 1, 9), (1, 83, 3)]):
        layers = [torch.from_numpy(bench_frames(*s, seed=5)).to(cuda) for s in shapes + extra]
        layers[-1][0, :5] = torch.from_numpy(rng.integers(0, 256, layers[-1][0, :5].shape,
                                                          dtype=np.uint8)).to(cuda)
        _kernels.reset_launches()
        got = harris_score_i32_layers(layers)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["harris_score_i32"] == (1 if not extra else 2)
        for g, im in zip(got, layers):
            assert torch.equal(g, harris_score_i32(im)), tuple(im.shape)


@pytest.mark.parametrize("thr", [0, 300])
def test_harris_mask_layers_cuda_one_launch(cuda, thr):
    """K3 on layers of mixed widths in one launch (the main path's four VGA
    layers), and with five odd and tiny ones more in two launches (the
    layer table holds eight); scores and mask bitwise equal to plain."""
    from ethzasl_brisk_tpu_torch import _kernels

    shapes = [(2, 480, 640), (2, 320, 426), (2, 240, 320), (2, 160, 213)]
    for extra in ([], [(1, 37, 70), (3, 4, 5), (1, 41, 121), (2, 1, 9), (1, 83, 3)]):
        layers = [torch.from_numpy(bench_frames(*s, seed=6)).to(cuda) for s in shapes + extra]
        _kernels.reset_launches()
        got = harris_score_mask_layers(layers, thr)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["harris_score_mask"] == (1 if not extra else 2)
        for (sc, mask), im in zip(got, layers):
            ref_sc, ref_mask = harris_score_mask_i32(im, thr)
            assert torch.equal(sc, ref_sc), tuple(im.shape)
            assert torch.equal(mask, ref_mask), tuple(im.shape)


@pytest.mark.parametrize("pattern_scale", [1.0, 0.6])
def test_sampler_cuda_edges(cuda, pattern_scale):
    """K2 where its taps clamp: keypoints on and beyond every edge and
    corner of the first and the last frame of the stack (the integral's
    last row), small-sigma and box points in one warp at pattern_scale 0.6,
    and K * P not a multiple of the block; bitwise against plain."""
    b, h, w = 3, 96, 130
    imgs = torch.from_numpy(bench_frames(b, h, w, seed=7)).to(cuda)
    host = brisk_v2_pattern(pattern_scale)
    xs = np.array([-40.0, -3.5, 0.0, 0.5, w / 2, w - 1.0, w - 0.25, w + 2.0, w + 40.0], np.float32)
    ys = np.array([-40.0, -2.5, 0.0, h / 2, h - 1.0, h + 3.0, h + 40.0], np.float32)
    kx, ky = (a.reshape(-1) for a in np.meshgrid(xs, ys))
    kx, ky = np.concatenate([kx, kx]), np.concatenate([ky, ky])
    k = kx.size
    frame = np.repeat(np.array([0, b - 1], np.int32), k // 2)
    sizes = np.resize(np.array([12.0, 18.0, 24.0, 36.0, 54.0], np.float32), k)
    sidx = scale_index(torch.from_numpy(sizes)).numpy()
    rot = (np.arange(k) * 37) % 1024

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cuda)

    args = (
        _stack_frames(imgs), t(kx), t(ky),
        t(host.lut_x[sidx, rot]), t(host.lut_y[sidx, rot]), t(host.lut_sigma[sidx]),
        t(host.lut_scaling[sidx]), t(host.lut_scaling2[sidx]), t(frame * (h + 1)), h,
    )
    assert (k * host.lut_x.shape[-1]) % 128 != 0
    got = smoothed_intensity_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, smoothed_intensity(*args))


def test_match_exact_with_tf32(cuda):
    """The +-1 float32 match stays bitwise equal to XOR + popcount with
    TF32 matmuls allowed: its operands and partial sums are exact."""
    from ethzasl_brisk_tpu_torch.match.matcher import (
        hamming_distance_matrix,
        hamming_distance_matrix_popcnt,
    )

    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.integers(-2**31, 2**31, (300, 12), dtype=np.int64)
                         .astype(np.int32)).to(cuda)
    tr = torch.from_numpy(rng.integers(-2**31, 2**31, (500, 12), dtype=np.int64)
                          .astype(np.int32)).to(cuda)
    tr[:50] = q[:50]
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = hamming_distance_matrix(q, tr)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert torch.equal(got.to(torch.int64), hamming_distance_matrix_popcnt(q, tr).to(torch.int64))


def test_kernels_on_the_second_card(cuda):
    """K1, K3, K2 and a probe kernel on cuda:1 while cuda:0 is current:
    each launches on the tensors' card, bitwise against plain."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from ethzasl_brisk_tpu_torch.probes import gather

    dev = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    imgs = torch.from_numpy(bench_frames(2, 120, 160)).to(dev)
    got = harris_score_i32_cuda(imgs)
    assert torch.equal(got, harris_score_i32(imgs))
    for a, b in zip(harris_score_mask_cuda(imgs, 20), harris_score_mask_i32(imgs, 20)):
        assert torch.equal(a, b)
    host = brisk_v2_pattern()
    k = 20
    sidx = np.full(k, 8)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    args = (_stack_frames(imgs), t(np.linspace(30, 130, k).astype(np.float32)),
            t(np.linspace(30, 90, k).astype(np.float32)), t(host.lut_x[sidx, 0]),
            t(host.lut_y[sidx, 0]), t(host.lut_sigma[sidx]), t(host.lut_scaling[sidx]),
            t(host.lut_scaling2[sidx]), t(np.zeros(k, np.int32)), 120)
    assert torch.equal(smoothed_intensity_cuda(*args), smoothed_intensity(*args))
    src = torch.arange(64 * 128, dtype=torch.int32, device=dev).view(64, 128)
    idx = torch.randint(0, 64, (32, 128), dtype=torch.int32, device=dev)
    assert torch.equal(gather.take_along_axis(src, idx, 0), gather.take_along_axis_plain(src, idx, 0))
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0


STEP_CONFIG = dict(
    octaves=2, uniformity_radius=30.0, absolute_threshold=20.0,
    max_candidates=(704, 256, 192, 96), max_keypoints=128,
    refine_capacity=(64, 32, 24, 16), describe_capacity=48,
)


def test_step_launches_both_kernels(cuda):
    from ethzasl_brisk_tpu_torch import FramePipeline, _kernels

    feature = BriskFeature(**STEP_CONFIG, device="cuda")
    frames = torch.from_numpy(bench_frames(3, 120, 160))
    _kernels.reset_launches()
    got = FramePipeline(feature, device="cuda").step(frames.to(cuda))
    assert _kernels.LAUNCHES["harris_score_i32"] == 1  # one launch for the 4 layers
    assert _kernels.LAUNCHES["harris_score_mask"] == 0
    assert _kernels.LAUNCHES["smoothed_intensity"] == 2
    ref = FramePipeline(BriskFeature(**STEP_CONFIG, device="cpu"), device="cpu").step(frames)
    assert torch.equal(got[0].valid.cpu(), ref[0].valid)
    assert torch.equal(got[0].response.cpu(), ref[0].response)


def test_fused_step_launches_k3_and_equals_default(cuda):
    """fused_mask=True: K3 once for the four layers, K1 never, K2 twice;
    every output bit-equal to the default step on the card."""
    from ethzasl_brisk_tpu_torch import FramePipeline, _kernels

    frames = torch.from_numpy(bench_frames(3, 120, 160)).to(cuda)
    default = FramePipeline(BriskFeature(**STEP_CONFIG, device="cuda"), device="cuda").step(frames)
    _kernels.reset_launches()
    fused = FramePipeline(BriskFeature(**STEP_CONFIG, fused_mask=True, device="cuda"),
                          device="cuda").step(frames)
    assert _kernels.LAUNCHES["harris_score_mask"] == 1
    assert _kernels.LAUNCHES["harris_score_i32"] == 0
    assert _kernels.LAUNCHES["smoothed_intensity"] == 2
    for a, b in zip(default[0].fields(), fused[0].fields()):
        assert torch.equal(a, b)
    for a, b in zip(default[1:], fused[1:]):
        assert torch.equal(a, b)


def test_entry_points_default_to_the_card(cuda):
    """No device argument: the buffers live on the card, and a host image
    comes back as outputs on the card."""
    from ethzasl_brisk_tpu_torch import FramePipeline, HarrisFeatureDetector

    feature = BriskFeature(octaves=0, absolute_threshold=20.0, max_candidates=2048)
    assert all(b.device.type == "cuda" for b in feature.buffers())
    img = torch.from_numpy(bench_frames(1, 120, 160)[0])
    kps, desc = feature.detect_and_compute(img)
    assert desc.device.type == "cuda" and all(f.device.type == "cuda" for f in kps.fields())
    assert HarrisFeatureDetector(threshold=20.0).detect(img).x.device.type == "cuda"
    assert FramePipeline(feature).device.type == "cuda"


def _gather_inputs(rng, dtype, shape_src, shape_idx, hi):
    src = rng.integers(0, 255 if dtype == np.uint8 else 1 << 22, shape_src).astype(dtype)
    return torch.from_numpy(src), torch.from_numpy(rng.integers(0, hi, shape_idx, dtype=np.int32))


@pytest.mark.parametrize("dtype", [np.int32, np.uint8])
@pytest.mark.parametrize("axis,blocks,src_shape,idx_shape", [
    (0, 1, (300, 128), (257, 128)),      # global rows, P1 / P3 width
    (0, 1, (300, 37), (41, 37)),         # a width that is no multiple of 32
    (0, 3, (3 * 64, 128), (3 * 72, 128)),  # block-local rows
    (0, 5, (5 * 50, 64), (5 * 50, 64)),
    (1, 1, (200, 128), (200, 128)),      # lane gather
    (1, 1, (200, 130), (200, 7)),
    (1, 1, (999, 128), (999,)),          # the 1-D index of pallas_lane
])
def test_take_along_axis_cuda_matches_plain(cuda, dtype, axis, blocks, src_shape, idx_shape):
    from ethzasl_brisk_tpu_torch.probes import gather

    rng = np.random.default_rng(11)
    hi = src_shape[0] // blocks if axis == 0 else src_shape[1]
    src, idx = (t.to(cuda) for t in _gather_inputs(rng, dtype, src_shape, idx_shape, hi))
    got = gather.take_along_axis(src, idx, axis, blocks)
    torch.cuda.synchronize()
    ref = gather.take_along_axis_plain(src, idx, axis, blocks)
    assert got.dtype == src.dtype and torch.equal(got, ref)


# Offsets in elements of the table, r and c in their storage: 4 bytes past a
# 16-byte boundary sends r or c to G2's scalar body, 16 bytes past does not.
POINT_VIEWS = {"aligned": (0, 0, 0), "tab 4 B past": (1, 0, 0), "r 4 B past": (0, 1, 0),
               "c 12 B past": (0, 0, 3), "r and c 16 B past": (0, 4, 4)}


@pytest.mark.parametrize("view", list(POINT_VIEWS))
@pytest.mark.parametrize("cols", [128, 130])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 2048, 5001])
def test_point_gather_cuda_matches_plain(cuda, n, cols, view):
    """G2 at whole and ragged quads of taps, on two table widths and on
    offset views: the body point_plan picks, one counted launch, bitwise
    against plain."""
    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.probes import gather

    rng = np.random.default_rng(12)
    rows = 97
    ot, o_r, oc = POINT_VIEWS[view]

    def stored(hi, size, off):
        return torch.from_numpy(rng.integers(0, hi, size + off, dtype=np.int32)).to(cuda)[off:]

    tab = stored(1 << 20, rows * cols, ot).view(rows, cols)
    r, c = stored(rows, n, o_r), stored(cols, n, oc)
    r[:1], c[-1:] = rows - 1, cols - 1
    assert gather.point_plan_for(tab, r, c).vector == (o_r % 4 == oc % 4 == 0)
    _kernels.reset_launches()
    got = gather.point_gather(tab, r, c)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["probe_point_gather"] == 1
    assert torch.equal(got, gather.point_gather_plain(tab, r, c))


def test_point_gather_bad_plan_raises(cuda):
    """The 16-byte body on a misaligned r, or a grid short of the taps, is
    refused before launch; a launch the card refuses (an empty grid) raises
    through the launch helper. None counts, and the next is not tainted."""
    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.probes import gather

    n = 5001
    tab = torch.arange(97 * 128, dtype=torch.int32, device=cuda).view(97, 128)
    r = torch.randint(0, 97, (n + 1,), dtype=torch.int32, device=cuda)
    c = torch.randint(0, 128, (n,), dtype=torch.int32, device=cuda)
    out = torch.empty(n, dtype=torch.int32, device=cuda)
    _kernels.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        gather._launch_point(tab, r[1:], c, out, gather.point_plan(n, 0, 0, 0))
    with pytest.raises(ValueError, match="cover"):
        gather._launch_point(tab, r[:n], c, out, gather.PointPlan(True, 2))
    with pytest.raises(RuntimeError, match="CUDA launch failed"):  # an empty grid
        _kernels.launch("probe_point_gather", "probe_point_gather", cuda, tab.data_ptr(),
                        r.data_ptr(), c.data_ptr(), out.data_ptr(), 128, n, 1, 0)
    assert _kernels.LAUNCHES["probe_point_gather"] == 0
    gather._launch_point(tab, r[:n], c, out, gather.point_plan(n, 0, 0, 0))
    torch.cuda.synchronize()
    assert torch.equal(out, gather.point_gather_plain(tab, r[:n], c))


@pytest.mark.parametrize("transpose", [True, False])
@pytest.mark.parametrize("shape", [(128, 4096), (8192, 64), (45, 77), (1, 33)])
def test_relayout_cuda_matches_plain(cuda, transpose, shape):
    from ethzasl_brisk_tpu_torch.probes import gather

    src = torch.from_numpy(np.random.default_rng(13).integers(0, 1 << 22, shape, dtype=np.int32))
    src = src.to(cuda)
    got = gather.relayout(src, transpose)
    torch.cuda.synchronize()
    assert torch.equal(got, gather.relayout_plain(src, transpose))


# (height, width, offset of the image in its storage in elements)
WINDOW_LAYOUTS = {
    "768": (130, 768, 0),
    "772": (97, 772, 0),
    "101": (130, 101, 0),
    "64": (70, 64, 0),
    "768, 4 B past": (130, 768, 1),
    "768, 16 B past": (130, 768, 4),
}


@pytest.mark.parametrize("k", [1, 128, 200, 1000])
@pytest.mark.parametrize("layout", list(WINDOW_LAYOUTS))
def test_window_copy_cuda_matches_plain(cuda, layout, k):
    """W on images whose rows are whole 16-byte chunks (16-byte moves), a
    ragged width and offset views (word loads); windows at every ax % 4 and
    at both image edges; one counted launch, bitwise against plain."""
    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.probes import gather

    h, w, offset = WINDOW_LAYOUTS[layout]
    rng = np.random.default_rng(14)
    store = rng.integers(-2**31, 2**31, h * w + offset, dtype=np.int64).astype(np.int32)
    img = torch.from_numpy(store).to(cuda)[offset:].view(h, w)
    ax = rng.integers(0, w - 63, k, dtype=np.int32)
    ay = rng.integers(0, h - 63, k, dtype=np.int32)
    edges = [(0, 0), (w - 64, h - 64), (1, h - 64), (2, 1), (3, 0), (w - 65, 2), (w - 66, 0),
             (w - 67, h - 64)]
    for i, (x, y) in enumerate(edges[:k]):
        ax[i], ay[i] = min(max(x, 0), w - 64), y
    if k > 4 and w > 66:
        assert set((ax % 4).tolist()) == {0, 1, 2, 3}
    ax, ay = torch.from_numpy(ax).to(cuda), torch.from_numpy(ay).to(cuda)
    assert gather.window_plan_for(img, ax, ay).vector == (w % 4 == 0 and offset % 4 == 0)
    _kernels.reset_launches()
    got = gather.window_copy(img, ax, ay)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["probe_window_copy"] == 1
    assert torch.equal(got, gather.window_copy_plain(img, ax, ay))


def test_window_copy_bad_plan_raises(cuda):
    """The 16-byte body on a misaligned image or a ragged width is refused
    before launch; a launch the card refuses (an empty grid) raises through
    the launch helper. No launch is counted, and the next is not tainted."""
    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.probes import gather

    h, k = 100, 8
    ax = torch.arange(k, dtype=torch.int32, device=cuda)
    ay = torch.zeros(k, dtype=torch.int32, device=cuda)
    out = torch.empty((k * 64, 64), dtype=torch.int32, device=cuda)
    off = torch.zeros(h * 768 + 1, dtype=torch.int32, device=cuda)[1:].view(h, 768)
    ragged = torch.zeros((h, 101), dtype=torch.int32, device=cuda)
    _kernels.reset_launches()
    for img in (off, ragged):
        with pytest.raises(ValueError, match="16-byte"):
            gather._launch_window(img, ax, ay, out, gather.WindowPlan(True))
    for vector in (0, 1):
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            _kernels.launch("probe_window_copy", "probe_window_copy", cuda, ragged.data_ptr(),
                            ax.data_ptr(), ay.data_ptr(), out.data_ptr(), 101, 0, vector)
    assert _kernels.LAUNCHES["probe_window_copy"] == 0
    img = torch.arange(h * 768, dtype=torch.int32, device=cuda).view(h, 768)
    got = gather.window_copy(img, ax, ay)
    torch.cuda.synchronize()
    assert torch.equal(got, gather.window_copy_plain(img, ax, ay))


def test_probe_wrappers_count_one_launch_each(cuda):
    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.probes import cases

    _kernels.reset_launches()
    for case in cases.CASES:
        kern = cases.KERNELS[case.kernel]
        kern.wrapper(*case.args(cases.tensors(case, False, cuda)))
    torch.cuda.synchronize()
    want = {}
    for case in cases.CASES:
        counter = cases.KERNELS[case.kernel].counter
        want[counter] = want.get(counter, 0) + 1
    assert {k: v for k, v in _kernels.LAUNCHES.items() if v} == want


@pytest.mark.parametrize("width", [37, 130])
@pytest.mark.parametrize("idx_width", [1, 7, 128])
@pytest.mark.parametrize("mode", ["float32", "widen", "shared"])
def test_take_along_axis_cuda_new_modes(cuda, mode, width, idx_width):
    """G1's float32 bits, uint8 widened to int32, and one source shared by
    row blocks (index rows three times the source rows), on axis 1."""
    from ethzasl_brisk_tpu_torch.probes import gather

    rng = np.random.default_rng(15)
    rows = 50
    dtype = np.uint8 if mode == "widen" else np.int32
    src, idx = _gather_inputs(rng, dtype, (rows, width),
                              (3 * rows if mode == "shared" else rows, idx_width), width)
    if mode == "float32":
        src = torch.from_numpy(rng.standard_normal((rows, width)).astype(np.float32))
    out_dtype = torch.int32 if mode == "widen" else None
    src, idx = src.to(cuda), idx.to(cuda)
    got = gather.take_along_axis(src, idx, 1, out_dtype=out_dtype)
    torch.cuda.synchronize()
    ref = gather.take_along_axis_plain(src, idx, 1, out_dtype=out_dtype)
    assert got.dtype == ref.dtype and torch.equal(got, ref)
    if mode == "float32":
        assert got.dtype == torch.float32
        assert torch.equal(got, torch.gather(src, 1, idx.long()))
    if mode == "widen":
        assert got.dtype == torch.int32


def test_lane_select_cuda_matches_one_hot(cuda):
    """Site 17's one-hot lane select: G1 on index column 0 equals the
    one-hot product and lane sum bit for bit on integer-valued floats."""
    from ethzasl_brisk_tpu_torch.probes import gather

    rng = np.random.default_rng(16)
    tab = torch.from_numpy(rng.integers(0, 1000, (256, 128)).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, 128, (256, 128), dtype=np.int32)).to(cuda)
    col = idx[:, :1].contiguous()
    got = gather.take_along_axis(tab, col, 1)
    torch.cuda.synchronize()
    assert torch.equal(got, gather.lane_select_plain(tab, col))


@pytest.mark.parametrize("rounds", [1, 3, 8])
@pytest.mark.parametrize("blocks", [1, 3, 132, 133])
def test_transpose_chain_cuda_matches_plain(cuda, blocks, rounds):
    """T at one and a few blocks and at the persistent grid's edge (132
    blocks are 4 tiles for each of a 132-SM card's 528 warps, 133 leave
    some warps a fifth), with odd counts of rounds, where the result is
    each block transposed, and the probe's 8."""
    from ethzasl_brisk_tpu_torch.probes import mosaic

    rng = np.random.default_rng(17)
    t = torch.from_numpy(rng.integers(-2**31, 2**31, (blocks * 128, 128), dtype=np.int64)
                         .astype(np.int32))
    t[0, :2] = torch.tensor([2**31 - 1, 2**31 - 5], dtype=torch.int32)  # the adds wrap
    t = t.to(cuda)
    got = mosaic.transpose_chain(t, rounds)
    torch.cuda.synchronize()
    assert torch.equal(got, mosaic.transpose_chain_plain(t, rounds))
    if rounds == 8:
        assert torch.equal(got, t + 8)
    else:
        assert torch.equal(got, torch.cat([b.T + rounds for b in t.split(128)]))


def test_transpose_chain_cuda_raises_on_ragged_rows(cuda):
    """The kernel takes whole 128 x 128 blocks only; the wrapper raises."""
    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.probes import mosaic

    _kernels.reset_launches()
    with pytest.raises(ValueError):
        mosaic.transpose_chain(torch.zeros((200, 128), dtype=torch.int32, device=cuda))
    assert _kernels.LAUNCHES["probe_transpose_chain"] == 0


@pytest.mark.parametrize("index", ["random", "zeros", "127"])
@pytest.mark.parametrize("blocks", [1, 3, 128, 133])
def test_gather_chain_cuda_matches_plain(cuda, blocks, index):
    """X at one and a few blocks, the probe's 128 (one wave) and 133 (more
    CTAs than a 132-SM card's SMs); i all 0 or all 127 puts every lane of
    a warp on one row of the staged block; t spans the whole int32 range."""
    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.probes import mosaic

    rng = np.random.default_rng(18)
    shape = (blocks * 128, 128)
    t = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    t[0, :2] = (2**31 - 1, -2**31)
    i = {"random": rng.integers(0, 128, shape), "zeros": np.zeros(shape),
         "127": np.full(shape, 127)}[index].astype(np.int32)
    t, i = torch.from_numpy(t).to(cuda), torch.from_numpy(i).to(cuda)
    _kernels.reset_launches()
    got = mosaic.gather_chain(t, i)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["probe_gather_chain"] == 1
    assert torch.equal(got, mosaic.gather_chain_plain(t, i))


def test_gather_chain_cuda_raises_on_misaligned_base(cuda):
    """X moves 16-byte chunks: a t, i or output 4 bytes past a 16-byte
    boundary raises before any launch; 16 bytes past is aligned and runs."""
    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.probes import mosaic

    rng = np.random.default_rng(20)
    n = 2 * 128 * 128
    store = torch.from_numpy(rng.integers(0, 128, n + 4, dtype=np.int32)).to(cuda)
    t = torch.from_numpy(rng.integers(0, 1 << 30, (256, 128), dtype=np.int32)).to(cuda)
    i = store[:n].view(256, 128)
    off = store[1:n + 1].view(256, 128)
    _kernels.reset_launches()
    for args in ((off, i), (t, off)):
        with pytest.raises(ValueError, match="16-byte"):
            mosaic.gather_chain(*args)
    with pytest.raises(ValueError, match="16-byte"):
        mosaic._launch_chain(t, i, store[1:n + 1].view(256, 128))
    assert _kernels.LAUNCHES["probe_gather_chain"] == 0
    past16 = store[4:n + 4].view(256, 128)
    got = mosaic.gather_chain(t, past16)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["probe_gather_chain"] == 1
    assert torch.equal(got, mosaic.gather_chain_plain(t, past16))


# (height, width, offset of the image in its storage in elements)
COLSUM_LAYOUTS = {
    "768": (200, 768, 0),
    "130": (200, 130, 0),
    "768, 4 B past": (200, 768, 1),
    "768, 16 B past": (200, 768, 4),
    "772, 8 B past": (150, 772, 2),
}


@pytest.mark.parametrize("values", ["bytes", "wrapping"])
@pytest.mark.parametrize("k", [1, 301, 513])
@pytest.mark.parametrize("width", list(COLSUM_LAYOUTS))
def test_window_colsum_cuda_matches_plain(cuda, width, k, values):
    """S on aligned images, a ragged width and offset views; windows at
    every ax % 4, at both image edges and one to three columns short of the
    right edge; K = 1, 301 and 513; values of the probes' byte range, or
    over all of int32 so the sums wrap."""
    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.probes import mosaic

    h, w, offset = COLSUM_LAYOUTS[width]
    rng = np.random.default_rng(19)
    lo, hi = (0, 255) if values == "bytes" else (-2**31, 2**31)
    store = rng.integers(lo, hi, h * w + offset, dtype=np.int64).astype(np.int32)
    img = torch.from_numpy(store).to(cuda)[offset:].view(h, w)
    assert img.data_ptr() % 16 == 4 * offset % 16
    ax = rng.integers(0, w - 127, k, dtype=np.int32)
    ay = rng.integers(0, h - 95, k, dtype=np.int32)
    edges = [(w - 128, h - 96), (w - 129, 0), (w - 130, h - 96), (w - 131, 3), (0, 0),
             (1, h - 96), (2, 1), (3, 2)]
    for n, (x, y) in enumerate(edges[:k]):
        ax[n], ay[n] = min(max(x, 0), w - 128), y
    if k > 8 and w >= 131:
        assert set((ax % 4).tolist()) == {0, 1, 2, 3}
    ax, ay = torch.from_numpy(ax).to(cuda), torch.from_numpy(ay).to(cuda)
    _kernels.reset_launches()
    got = mosaic.window_colsum(img, ax, ay)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["probe_window_colsum"] == 1
    assert torch.equal(got, mosaic.window_colsum_plain(img, ax, ay))


def test_device_time_flushes_and_waits_on_its_card(cuda):
    """measure.device_time on cuda:1 while cuda:0 is current: the L2 flush
    buffer lives on cuda:1, not cuda:0, and the timed kernel's time is
    read."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from ethzasl_brisk_tpu_torch import measure

    dev = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    imgs = torch.from_numpy(bench_frames(4, 480, 640)).to(dev)
    for d in (0, 1):
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    base = [torch.cuda.memory_allocated(d) for d in (0, 1)]
    ms = measure.device_time(lambda: harris_score_i32_cuda(imgs), dev, ("harris_rows_kernel",),
                             reps=3, warmup=1)
    assert 0 < ms < 100
    assert torch.cuda.max_memory_allocated(1) - base[1] >= 2 * measure.L2_BYTES
    assert torch.cuda.max_memory_allocated(0) - base[0] < measure.L2_BYTES
    assert torch.cuda.current_device() == 0


def _take_call(rng, dtype, src_shape, idx_shape, axis, blocks=1):
    """Card tensors for a G1 call: a table of ``dtype`` (float32 with
    NaNs, infinities and -0.0, so its bits are what moves) and in-range
    indices."""
    if dtype == np.float32:
        src = rng.standard_normal(src_shape).astype(np.float32)
        src.reshape(-1)[:4] = [np.nan, -np.inf, -0.0, np.inf]
    else:
        src = rng.integers(0, 255 if dtype == np.uint8 else 1 << 30, src_shape).astype(dtype)
    hi = src_shape[0] // blocks if axis == 0 else src_shape[1]
    idx = rng.integers(0, hi, idx_shape, dtype=np.int32)
    return torch.from_numpy(src).cuda(), torch.from_numpy(idx).cuda()


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


# (body: R, L, or D with (D4) or without (D1) 16-byte moves; dtype, out
# dtype, src shape, idx shape, axis, blocks)
TAKE_BODIES = [
    ("R", np.int32, None, (3 * 1001, 96), (3 * 777, 96), 0, 3),    # S no multiple of 8
    ("R", np.float32, None, (2 * 600, 8), (2 * 900, 8), 0, 2),     # one band
    ("R", np.int32, None, (2000, 128), (5000, 128), 0, 1),         # B = 1: row splits
    ("L", np.int32, None, (1001, 128), (1001, 128), 1, 1),         # groups of 16 rows, ragged
    ("L", np.float32, None, (300, 128), (300, 128), 1, 1),
    ("L", np.uint8, None, (1001, 128), (1001, 128), 1, 1),
    ("L", np.uint8, torch.int32, (1001, 128), (1001, 128), 1, 1),
    ("L", np.int32, None, (60, 256), (60, 20), 1, 1),              # 5 chunks a row
    ("L", np.int32, None, (50, 2432), (7 * 50, 128), 1, 1),        # shared source
    ("L", np.int32, None, (45, 128), (64 * 45, 128), 1, 1),        # shared, ragged groups
    ("D1", np.int32, None, (300, 37), (41, 37), 0, 1),
    ("D1", np.uint8, torch.int32, (200, 130), (600, 37), 1, 1),
    ("D4", np.int32, None, (5 * 50, 64), (5 * 60, 64), 0, 5),
    ("D4", np.uint8, None, (200, 130), (400, 8), 1, 1),
    ("D4", np.float32, None, (200, 130), (200, 128), 1, 1),
]


@pytest.mark.parametrize("body,dtype,out_dtype,src_shape,idx_shape,axis,blocks", TAKE_BODIES)
def test_take_bodies_match_plain(cuda, body, dtype, out_dtype, src_shape, idx_shape, axis,
                                 blocks):
    """Each G1 body, launched with its own plan, bitwise against the plain
    version: ragged bands, groups and splits, every element type, and the
    shared source."""
    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.probes import gather

    src, idx = _take_call(np.random.default_rng(31), dtype, src_shape, idx_shape, axis, blocks)
    g, out_dtype = gather._take_geometry(src, idx, axis, blocks, out_dtype)
    plan = {"R": lambda: gather.rows_plan(g), "L": lambda: gather.lanes_plan(g),
            "D1": lambda: gather.direct_plan(g, False),
            "D4": lambda: gather.direct_plan(g, True)}[body]()
    assert plan is not None and plan.body[0] == body[0].lower()
    if body == "R" and blocks == 1:
        assert -(-g.r // plan.rows) > 1  # the index rows split across CTAs
    out = torch.empty(idx.shape, dtype=out_dtype, device=cuda)
    _kernels.reset_launches()
    gather._launch_take(src, idx, out, g, plan)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["probe_take"] == 1
    ref = gather.take_along_axis_plain(src, idx, axis, blocks, out_dtype)
    assert out.dtype == ref.dtype and torch.equal(_bits(out), _bits(ref))


def test_take_plan_routes_by_alignment(cuda):
    """Views with a storage offset: an index 4 bytes past a 16-byte
    boundary, or an output so placed, gets the one-output-a-thread body; 16
    bytes past, the aligned call's body. Each bitwise against plain."""
    from ethzasl_brisk_tpu_torch.probes import gather

    rows = 1 << 13
    src, idx = _take_call(np.random.default_rng(32), np.int32, (rows, 128), (rows + 1, 128), 1)
    g, _ = gather._take_geometry(src, idx[:rows], 1, 1)
    for off in (1, 4):
        view = idx.view(-1)[off: off + rows * 128].view(rows, 128)
        plan = gather.take_plan_for(src, view, 1)
        assert plan == (gather.direct_plan(g, False) if off == 1 else gather.take_plan(g, 0, 0, 0))
        got = gather.take_along_axis(src, view, 1)
        torch.cuda.synchronize()
        assert torch.equal(got, gather.take_along_axis_plain(src, view, 1))
    store = torch.empty(rows * 128 + 1, dtype=torch.int32, device=cuda)
    out = store[1:].view(rows, 128)
    plan = gather.take_plan(g, 0, 0, out.data_ptr() % 16)
    assert plan == gather.direct_plan(g, False)
    gather._launch_take(src, idx[:rows], out, g, plan)
    torch.cuda.synchronize()
    assert torch.equal(out, gather.take_along_axis_plain(src, idx[:rows], 1))


def test_take_unlaunchable_plan_raises(cuda):
    """A plan the card refuses (R with twice its block's threads) raises
    through the launch helper and counts no launch; one over the shared
    memory a block may take is refused before it."""
    import dataclasses

    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.probes import gather

    src, idx = _take_call(np.random.default_rng(33), np.int32, (4 * 512, 128), (4 * 512, 128),
                          0, 4)
    g, _ = gather._take_geometry(src, idx, 0, 4)
    plan = gather.rows_plan(g)
    out = torch.empty_like(idx)
    _kernels.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        gather._launch_take(src, idx, out, g, dataclasses.replace(plan, threads=1024))
    with pytest.raises(ValueError, match="shared memory"):
        gather._launch_take(src, idx, out, g,
                            dataclasses.replace(plan, smem=gather.SMEM_LIMIT + 16))
    assert _kernels.LAUNCHES["probe_take"] == 0
    gather._launch_take(src, idx, out, g, plan)  # the next launch is not tainted
    torch.cuda.synchronize()
    assert torch.equal(out, gather.take_along_axis_plain(src, idx, 0, 4))


@pytest.mark.parametrize("transpose", [True, False])
@pytest.mark.parametrize("offset", [1, 4])
@pytest.mark.parametrize("shape", [(128, 4096), (8192, 64), (45, 77), (1, 33)])
def test_relayout_cuda_offset_views(cuda, transpose, offset, shape):
    """C on a source that is a view with a storage offset: 4 bytes past a
    16-byte boundary takes the 4-byte moves, 16 bytes past the 16-byte ones
    where the shape allows; bitwise against plain either way."""
    from ethzasl_brisk_tpu_torch.probes import gather

    n = shape[0] * shape[1]
    store = torch.from_numpy(np.random.default_rng(34).integers(0, 1 << 30, n + offset,
                                                                dtype=np.int32)).to(cuda)
    src = store[offset:].view(shape)
    assert src.data_ptr() % 16 == 4 * offset % 16
    got = gather.relayout(src, transpose)
    torch.cuda.synchronize()
    assert torch.equal(got, gather.relayout_plain(src, transpose))


AST_CONFIG = dict(threshold=40, octaves=2, max_candidates_per_layer=(1024, 512, 256, 128))


def _assert_ast_outputs(got, ref):
    """Card against CPU: every keypoint field, the angle included, the
    descriptors and the matches bit for bit."""
    kg, kc = got[0], ref[0]
    for name in ("x", "y", "size", "angle", "response", "octave", "valid"):
        assert torch.equal(getattr(kg, name).cpu(), getattr(kc, name)), name
    for i, what in ((1, "descriptors"), (2, "match index"), (3, "match distance")):
        assert torch.equal(got[i].cpu(), ref[i]), what


@pytest.mark.parametrize("model", ["emulated", "exact"])
def test_ast_step_on_card_matches_cpu(cuda, model):
    """The AST step on the card: K2 twice, K1 and K3 never; its outputs
    against the same step on the CPU."""
    from ethzasl_brisk_tpu_torch import AstFramePipeline, BriskFeatureDetector, _kernels

    frames = torch.from_numpy(bench_frames(3, 160, 212, seed=5))
    cfg = dict(AST_CONFIG, raw_cache_model=model)
    pipe = AstFramePipeline(BriskFeatureDetector(**cfg, device="cuda"), device="cuda",
                            describe_capacity=200)
    _kernels.reset_launches()
    got = pipe.step(frames)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["smoothed_intensity"] == 2
    assert _kernels.LAUNCHES["harris_score_i32"] == _kernels.LAUNCHES["harris_score_mask"] == 0
    ref = AstFramePipeline(BriskFeatureDetector(**cfg, device="cpu"), device="cpu",
                           describe_capacity=200).step(frames)
    assert int(ref[0].valid.sum()) > 100
    _assert_ast_outputs(got, ref)


def test_ast_compute_scale_on_card_matches_cpu(cuda):
    from ethzasl_brisk_tpu_torch import BriskFeatureDetector, KeyPoints, compute_scale

    frame = torch.from_numpy(bench_frames(1, 160, 212, seed=6)[0])
    det_cpu = BriskFeatureDetector(**AST_CONFIG, device="cpu")
    kps = det_cpu.detect(frame)
    cols = {f: getattr(kps, f)[kps.valid].numpy() for f in ("x", "y", "size")}
    ref = compute_scale(det_cpu, frame, KeyPoints.from_numpy(**cols, device="cpu"))
    got = compute_scale(BriskFeatureDetector(**AST_CONFIG, device="cuda"), frame,
                        KeyPoints.from_numpy(**cols, device="cuda"))
    for a, b in zip(got.fields(), ref.fields()):
        assert torch.equal(a.cpu(), b)
    assert int(ref.valid.sum()) > 50


@pytest.mark.parametrize("pattern_scale", [1.0, 0.5])
def test_sampler_v1_cuda_matches_plain(cuda, pattern_scale):
    """K2's v1-rounding variant against its plain version, counted as
    ``smoothed_intensity_v1``: the v1 ring at pattern_scale 0.5 puts the
    sigmas of scale index 0 (sizes under ~7.5) below 0.5, so both branches
    run; clipped taps too."""
    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.core.pattern import brisk_v1_pattern

    rng = np.random.default_rng(2)
    b, h, w, k = 3, 120, 160, 200
    imgs = torch.from_numpy(bench_frames(b, h, w)).to(cuda)
    host = brisk_v1_pattern(pattern_scale)
    sizes = torch.from_numpy(rng.choice([5.0, 7.0, 12.0, 24.0, 54.0], b * k).astype(np.float32))
    sidx = scale_index(sizes).numpy()
    rot = rng.integers(0, 1024, b * k)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cuda)

    args = (
        _stack_frames(imgs),
        t(rng.uniform(-5, w + 5, b * k).astype(np.float32)),
        t(rng.uniform(-5, h + 5, b * k).astype(np.float32)),
        t(host.lut_x[sidx, rot]), t(host.lut_y[sidx, rot]), t(host.lut_sigma[sidx]),
        t(host.lut_scaling[sidx]), t(host.lut_scaling2[sidx]),
        t(np.repeat(np.arange(b, dtype=np.int32) * (h + 1), k)), h, True,
    )
    assert bool((args[5] < 0.5).any()) == (pattern_scale == 0.5)
    _kernels.reset_launches()
    got = smoothed_intensity_cuda(*args)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["smoothed_intensity_v1"] == 1
    assert _kernels.LAUNCHES["smoothed_intensity"] == 0
    assert torch.equal(got, smoothed_intensity(*args))
    assert not torch.equal(got, smoothed_intensity_cuda(*args[:-1])), "v1 rounds otherwise"


def test_v1_facade_on_card_matches_cpu(cuda):
    """``BriskFeatureDetector(version="v1")`` on the card: K2's v1 variant
    twice; every field, the angle included, and every descriptor bit for
    bit against the CPU."""
    from ethzasl_brisk_tpu_torch import BriskFeatureDetector, _kernels

    frame = torch.from_numpy(bench_frames(1, 160, 212, seed=5)[0])
    cfg = dict(threshold=35, octaves=3, max_candidates_per_layer=512, version="v1")
    _kernels.reset_launches()
    got = BriskFeatureDetector(**cfg, device="cuda").detect_and_compute(frame)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["smoothed_intensity_v1"] == 2
    assert _kernels.LAUNCHES["smoothed_intensity"] == 0
    ref = BriskFeatureDetector(**cfg, device="cpu").detect_and_compute(frame)
    assert got[1].shape == (got[0].capacity, 16) and int(ref[0].valid.sum()) > 20
    kg, kc = got[0], ref[0]
    for name in ("x", "y", "size", "angle", "response", "octave", "valid"):
        assert torch.equal(getattr(kg, name).cpu(), getattr(kc, name)), name
    assert torch.equal(got[1].cpu(), ref[1])


def test_camera_grid_on_card_matches_cpu(cuda):
    """The camera-aware grid on the card: K1 once, K2 twice (v2 rounding),
    the angle kernels once each; keypoints, the angle included, and
    descriptors bit for bit against the CPU (glibc's float32 ``atan2``,
    ``sin`` and ``cos`` on both)."""
    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.geometry import PinholeCamera, RadialTangentialDistortion
    from ethzasl_brisk_tpu_torch.geometry.camera_aware import CameraAwareFeatureGrid

    frame = torch.from_numpy(bench_frames(1, 240, 320, seed=8)[0])
    cam = PinholeCamera(260.0, 260.0, 160.0, 120.0, 320, 240,
                        RadialTangentialDistortion(-0.25, 0.06, 0.0, 0.0))
    kw = dict(octaves=0, uniformity_radius=0.0, absolute_threshold=35.0, max_candidates=512,
              max_keypoints=512)
    grid = CameraAwareFeatureGrid(cam, BriskFeature(**kw), margin=40)
    _kernels.reset_launches()
    got = grid.detect_and_compute(frame)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["harris_score_i32"] == 1
    assert _kernels.LAUNCHES["smoothed_intensity"] == 2
    assert _kernels.LAUNCHES["smoothed_intensity_v1"] == 0
    assert _kernels.LAUNCHES["brisk_orientation"] == 1
    assert _kernels.LAUNCHES["atan2f_elementwise"] == _kernels.LAUNCHES["sincosf_elementwise"] == 1
    ref = CameraAwareFeatureGrid(cam, BriskFeature(**kw, device="cpu"), margin=40,
                                 device="cpu").detect_and_compute(frame)
    kg, kc = got[0], ref[0]
    for name in ("x", "y", "size", "angle", "response", "octave", "valid"):
        assert torch.equal(getattr(kg, name).cpu(), getattr(kc, name)), name
    assert torch.equal(got[1].cpu(), ref[1]) and int(kc.valid.sum()) > 50


def _vo_frames(n):
    from ethzasl_brisk_tpu_torch.frames import make_texture, render_scene, trajectory
    from ethzasl_brisk_tpu_torch.geometry import PinholeCamera

    cam = PinholeCamera(200.0, 200.0, 160.0, 120.0, 320, 240)
    tex = make_texture(np.random.default_rng(11))
    return cam, [render_scene(tex, cam, r, t) for r, t in trajectory(n)]


def test_svd_null_vectors_on_card(cuda):
    """RANSAC's batched (512, 8, 9) and (256, 8, 9) systems: the card's
    ``svd(full_matrices=True)`` hands back the 9th right singular vector."""
    rng = np.random.default_rng(0)
    for shape in ((512, 8, 9), (256, 8, 9)):
        a = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
        v = torch.linalg.svd(a.to(cuda), full_matrices=True)[2][..., -1, :].cpu()
        ref = torch.linalg.svd(a.double(), full_matrices=True)[2][..., -1, :]
        assert float(torch.linalg.vector_norm(a @ v[..., None], dim=(-2, -1)).max()) < 1e-4
        assert float((v.double() * ref).sum(-1).abs().min()) > 1 - 1e-4


def test_relative_pose_on_card_matches_cpu(cuda):
    """``VoFrontend`` on the card against a ``device="cpu"`` twin on two
    240 x 320 frames: detection, angles and descriptors bitwise, and with
    the same draws the relative pose within 1e-3
    (the card's and the CPU's float32 SVDs differ in the last digits) and
    the inlier counts within 2 % and 2. The default draw (a
    generator on the card) runs without a host sync error."""
    from ethzasl_brisk_tpu_torch.geometry.ransac import sample_indices
    from ethzasl_brisk_tpu_torch.vo import VoConfig, VoFrontend

    cam, frames = _vo_frames(3)
    kw = dict(octaves=2, uniformity_radius=0.0, absolute_threshold=30.0, max_candidates=2048,
              max_keypoints=1024)
    cfg = VoConfig(normalize_exposure=True, min_inlier_spread=0.15)
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        vo = VoFrontend(cam, BriskFeature(**kw, device=dev), cfg)
        a = vo.process_frame(torch.from_numpy(frames[0]))
        b = vo.process_frame(torch.from_numpy(frames[2]))
        gen = torch.Generator().manual_seed(5)

        def draw(n, k, w):
            return sample_indices(torch.rand((n, k), generator=gen, dtype=torch.float64)
                                  .to(w.device), w)

        outs[dev.type] = (a, b, vo.relative_pose(None, *a, *b, draw=draw))
        if dev.type == "cuda":
            own = vo.relative_pose(torch.Generator(dev).manual_seed(0), *a, *b)
            assert own[0].device.type == "cuda" and bool(own[3])
    (ga, gb, gp), (ca, cb, cp) = outs["cuda"], outs["cpu"]
    for (kg, dg), (kc, dc) in ((ga, ca), (gb, cb)):
        for name in ("x", "y", "size", "angle", "response", "octave", "valid"):
            assert torch.equal(getattr(kg, name).cpu(), getattr(kc, name)), name
        assert torch.equal(dg.cpu(), dc)
    assert bool(gp[3]) and bool(cp[3])
    assert float((gp[0].cpu() - cp[0]).abs().max()) < 1e-3
    assert float((gp[1].cpu() - cp[1]).abs().max()) < 1e-3
    assert abs(int(gp[2]) - int(cp[2])) <= 0.02 * int(cp[2]) + 2


def _ba_window(dtype, seed=3):
    """tests/test_ba.py's dense window (6 poses along x, 200 points), in
    numpy: poses 0 and 1 exact, the others and the points perturbed."""
    from ethzasl_brisk_tpu_torch.ba.se3 import so3_exp

    rng = np.random.default_rng(seed)
    k, n_lm = 6, 200
    pts = rng.uniform([-3, -2, 4], [3, 2, 10], (n_lm, 3))
    t_cam = -np.stack([np.linspace(0, 1.0, k), np.zeros(k), np.zeros(k)], 1)
    kf = np.repeat(np.arange(k), n_lm)
    lm = np.tile(np.arange(n_lm), k)
    x_c = pts[lm] + t_cam[kf]
    uv = np.stack([400 * x_c[:, 0] / x_c[:, 2] + 320, 400 * x_c[:, 1] / x_c[:, 2] + 240], 1)
    uv += rng.normal(0, 0.3, uv.shape)
    w = rng.normal(0, 0.02, (k, 3))
    w[:2] = 0
    t0 = t_cam + rng.normal(0, 0.02, (k, 3)) * (np.arange(k) >= 2)[:, None]
    return dict(r=so3_exp(torch.from_numpy(w)).numpy().astype(dtype), t=t0.astype(dtype),
                points=(pts + rng.normal(0, 0.1, pts.shape)).astype(dtype), kf_idx=kf,
                lm_idx=lm, uv=uv.astype(dtype), valid=np.ones(len(kf), bool),
                fu=np.asarray(400.0, dtype), fv=np.asarray(400.0, dtype),
                cu=np.asarray(320.0, dtype), cv=np.asarray(240.0, dtype))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lm_window_on_card_matches_cpu(cuda, dtype):
    """One LM window (kitti_eval's settings: 12 iterations, damping 1e-2,
    fix_poses 2, Huber 3) on the card against the CPU. The batched products
    and solves round otherwise on the card, so: float64 poses within 1e-8
    and costs within 1e-9 relative; float32 poses within 5e-3, final costs
    within 1 %."""
    from ethzasl_brisk_tpu_torch.ba.window import BaProblem, solve_window_ba_lm

    arrays = _ba_window(dtype)
    outs = [solve_window_ba_lm(BaProblem.from_numpy(arrays, dev), iterations=12, damping=1e-2,
                               fix_poses=2, huber_delta=3.0) for dev in (cuda, "cpu")]
    (g, gc, _), (c, cc, _) = outs
    assert g.t.device.type == "cuda" and bool(torch.isfinite(gc).all())
    f64 = dtype == np.float64
    for f in ("r", "t"):
        assert float((getattr(g, f).cpu() - getattr(c, f)).abs().max()) < (1e-8 if f64 else 5e-3)
    rel = float((gc.cpu() - cc).abs().max() / cc[0]) if f64 else \
        abs(float(gc[-1]) - float(cc[-1])) / float(cc[-1])
    assert rel < (1e-9 if f64 else 1e-2), rel


def test_pose_graph_on_card_matches_cpu(cuda):
    """tests/test_ba.py's 12-node loop with a repeated edge, float32: the
    card within 5e-5 of the CPU, and converged."""
    from ethzasl_brisk_tpu_torch.ba.pose_graph import PoseGraph, optimize_pose_graph
    from ethzasl_brisk_tpu_torch.ba.se3 import so3_exp

    n = 12
    rng = np.random.default_rng(7)
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    r_gt = np.stack([[[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
                     for a in ang])
    t_gt = -np.einsum("nij,nj->ni", r_gt, np.stack([5 * np.cos(ang), 5 * np.sin(ang),
                                                     np.zeros(n)], 1))
    ei = np.append(np.arange(n - 1), [n - 1, 3])
    ej = np.append(np.arange(1, n), [0, 4])
    rel_r = np.einsum("nij,nkj->nik", r_gt[ei], r_gt[ej])
    rel_t = t_gt[ei] - np.einsum("nij,nj->ni", rel_r, t_gt[ej])
    w = rng.normal(0, 0.03, (n, 3))
    w[0] = 0
    r0 = so3_exp(torch.from_numpy(w)).numpy() @ r_gt
    t0 = t_gt + rng.normal(0, 0.2, (n, 3)) * (np.arange(n) > 0)[:, None]
    arrays = dict(r=r0.astype(np.float32), t=t0.astype(np.float32), edge_i=ei, edge_j=ej,
                  rel_r=rel_r.astype(np.float32), rel_t=rel_t.astype(np.float32),
                  weight=np.ones(len(ei), np.float32))
    (g, gc), (c, cc) = [optimize_pose_graph(PoseGraph.from_numpy(arrays, dev), iterations=15,
                                            damping=1e-5) for dev in (cuda, "cpu")]
    assert float((g.t.cpu() - c.t).abs().max()) < 5e-5
    assert float((g.r.cpu() - c.r).abs().max()) < 5e-5
    assert float(gc[-1]) < 1e-6


def _angle_inputs():
    rng = np.random.default_rng(12)
    n = 1 << 20
    ints = rng.integers(-200_000, 200_001, (2, n)).astype(np.float32)
    mag = 10.0 ** rng.uniform(-8, 8, (2, n)) * rng.choice([-1.0, 1.0], (2, n))
    sp = np.array([0.0, -0.0, 1.0, -1.0, 3.0, 1e-30, np.inf, -np.inf], np.float32)
    grid = np.stack(np.meshgrid(sp, sp)).reshape(2, -1)
    return np.concatenate([ints, mag.astype(np.float32), grid], axis=1)


def test_atan2f_kernel_matches_plain(cuda):
    """Kernel ``atan2f_elementwise`` against the plain chain on the CPU (the
    JAX package's ``jnp.arctan2``), bit for bit, one launch."""
    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.core.atan2f import atan2f, atan2f_plain

    y, x = (torch.from_numpy(v) for v in _angle_inputs())
    _kernels.reset_launches()
    got = atan2f(y.to(cuda), x.to(cuda))
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["atan2f_elementwise"] == 1
    assert torch.equal(got.cpu().view(torch.int32), atan2f_plain(y, x).view(torch.int32))


def test_sincosf_kernel_matches_plain(cuda):
    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.core.sincosf import sincosf, sincosf_plain

    rng = np.random.default_rng(13)
    mag = 10.0 ** rng.uniform(-10, 38, 1 << 18) * rng.choice([-1.0, 1.0], 1 << 18)
    a = torch.from_numpy(np.concatenate([rng.uniform(-7, 7, 1 << 20), mag,
                                         [0.0, -0.0, 120.0, np.inf, np.nan]]).astype(np.float32))
    _kernels.reset_launches()
    got = sincosf(a.to(cuda))
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["sincosf_elementwise"] == 1
    for g, r in zip(got, sincosf_plain(a)):
        g = g.cpu()
        same = (g.view(torch.int32) == r.view(torch.int32)) | (g.isnan() & r.isnan())
        assert bool(same.all())


@pytest.mark.parametrize("op_by_op", [False, True])
def test_orientation_kernel_matches_plain(cuda, op_by_op):
    """Kernel ``brisk_orientation``: angle and theta of the long-pair sums,
    given angles one ULP around the bin edges, bit for bit the plain
    chain on the CPU, one launch."""
    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.describe.orientation import orientation, orientation_plain

    rng = np.random.default_rng(14)
    n = 1 << 20
    d0, d1 = (torch.from_numpy(v) for v in rng.integers(-200_000, 200_001, (2, n), np.int32))
    edges = ((np.arange(-1024, 1024) - 0.5) * 360.0 / 1024).astype(np.float32).view(np.int32)
    near = np.concatenate([(edges + d).view(np.float32) for d in (-1, 0, 1)])
    given = torch.from_numpy(rng.choice(near, n))
    need = torch.from_numpy(rng.random(n) < 0.5)
    _kernels.reset_launches()
    ga, gt = orientation(*(t.to(cuda) for t in (d0, d1, given, need)), op_by_op=op_by_op)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["brisk_orientation"] == 1
    ra, rt = orientation_plain(d0, d1, given, need, op_by_op=op_by_op)
    assert torch.equal(ga.cpu().view(torch.int32), ra.view(torch.int32))
    assert torch.equal(gt.cpu(), rt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(), (3,), (6, 6), (6, 3), (300,)])
@pytest.mark.parametrize("n, o, head", [(5000, 200_000, 0.0), (6, 4096, 0.6), (5000, 20_000, 0.0)],
                         ids=["long", "padded-window", "short"])
def test_segment_sum_kernel_matches_plain(cuda, dtype, shape, n, o, head):
    """Kernel ``segment_sum`` against the CPU's ``index_add_``: repeated,
    empty and dropped indices, long segments, a padded window's first
    keyframe holding ``head`` of the rows, short segments, rows wider than
    a block, bit for bit, one launch; twice the same."""
    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.ba.segment import (
        segment_plan,
        segment_sum,
        segment_sum_plain,
    )

    rng = np.random.default_rng(15)
    idx = torch.from_numpy(rng.integers(-2, n, o))
    idx[torch.from_numpy(rng.random(o) < head)] = 0
    idx[idx == 3] = 4
    values = torch.from_numpy(rng.normal(0, 1, (o, *shape)) * 10.0 ** rng.integers(-5, 5, (o, *shape))).to(dtype)
    ref = segment_sum_plain(values, segment_plan(idx, n))
    plan = segment_plan(idx.to(cuda), n)
    _kernels.reset_launches()
    got = [segment_sum(values.to(cuda), plan) for _ in range(2)]
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["segment_sum"] == 2
    assert torch.equal(got[0].cpu(), ref) and torch.equal(got[1], got[0])


def test_lm_window_two_card_runs_bitwise(cuda):
    """Two LM solves of one window on the card, deterministic algorithms
    off: bitwise equal (the segment sums add in one order)."""
    from ethzasl_brisk_tpu_torch.ba.window import BaProblem, solve_window_ba_lm

    assert not torch.are_deterministic_algorithms_enabled()
    arrays = _ba_window(np.float32)
    runs = [solve_window_ba_lm(BaProblem.from_numpy(arrays, cuda), iterations=12, damping=1e-2,
                               fix_poses=2, huber_delta=3.0) for _ in range(2)]
    for a, b in zip((runs[0][0].r, runs[0][0].t, runs[0][0].points, runs[0][1]),
                    (runs[1][0].r, runs[1][0].t, runs[1][0].points, runs[1][1])):
        assert torch.equal(a, b)
