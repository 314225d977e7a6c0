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
from ethzasl_brisk_tpu_torch.detect.uniformity import (
    WINDOW,
    enforce_uniformity_cuda,
    enforce_uniformity_grid_plain,
    enforce_uniformity_plain,
    enforce_uniformity_scan_plain,
    layer_plan,
)
from ethzasl_brisk_tpu_torch.frames import bench_frames
from ethzasl_brisk_tpu_torch.kernels.harris import (
    harris_score_i32,
    harris_score_i32_cuda,
    harris_score_mask_cuda,
    harris_score_mask_i32,
    harris_score_mask_layers,
)
from tests import _candidate_cases as candidate_cases
from tests import _mask_cases as mask_cases
from tests import _match_cases as match_cases
from tests import _pyramid_cases as pyramid_cases
from tests._uniformity_cases import CASES as UNIFORMITY_CASES, case as uniformity_case

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
    """K1, K3, K2, a probe kernel and enforce_uniformity on cuda:1 while
    cuda:0 is current:
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
    u_args = [torch.from_numpy(a) for a in uniformity_case("r10_int_uncapped")[:4]]
    u_got = enforce_uniformity_cuda([(*(a.to(dev) for a in u_args), 2**31 - 1)], radius=10.0)[0]
    assert torch.equal(u_got.cpu(), enforce_uniformity_plain(*u_args, radius=10.0,
                                                             max_num_kpt=2**31 - 1))
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0


def _mask_frames(b: int, h: int, w: int) -> torch.Tensor:
    """Smoothed noise, then a flat frame (ties; at threshold 0 the zero
    fill decides) and sharp boxes (large negative scores on their edges)."""
    frames = bench_frames(b, h, w, seed=h + w)
    frames[1] = 77
    frames[2] = 40
    for k in range(4):
        y, x = (h * (2 * k + 1)) // 9, (w * (3 * k + 1)) // 13
        frames[2, y : y + 4 + 3 * k, x : x + 5 + 2 * k] = 220
    return torch.from_numpy(frames)


@pytest.mark.parametrize("fused", [False, True], ids=["2d-mask", "fused"])
@pytest.mark.parametrize("thr", [0, 20])
@pytest.mark.parametrize(
    "shape,octaves", [((16, 480, 640), 2), ((3, 61, 83), 2), ((3, 96, 130), 2),
                      ((3, 61, 83), 1), ((3, 96, 130), 0), ((3, 480, 640), 5)],
    ids=["b16-step", "61x83", "96x130", "61x83-oct1", "96x130-oct0", "vga-10-layers"])
def test_score_masks_cuda_matches_plain(cuda, shape, octaves, thr, fused):
    """Kernel score_masks bit for bit against the plain version on the
    card: the B=16 step's four VGA layers, odd shapes whose layers reach
    the extrapolating edge and the undefined taps, one layer, and ten
    layers (two launches: the table holds eight). One launch a detection;
    none for a single layer with K3's mask, which is already the answer."""
    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.detect import scale_space
    from ethzasl_brisk_tpu_torch.kernels import masks

    n_layers = max(2 * octaves, 1)
    pyr = scale_space.build_pyramid(_mask_frames(*shape).to(cuda), n_layers)
    maps = [(scale_space.layer_geometry(i).above_map, scale_space.layer_geometry(i).below_map)
            for i in range(n_layers)]
    if fused:
        pairs = harris_score_mask_layers(pyr, thr)
        scores, base = [p[0] for p in pairs], [p[1] for p in pairs]
    else:
        scores, base = [harris_score_i32(p) for p in pyr], None
    _kernels.reset_launches()
    got = masks.score_masks(scores, thr, maps, base)
    torch.cuda.synchronize()
    want_launches = 0 if fused and n_layers == 1 else (n_layers + 7) // 8
    assert _kernels.LAUNCHES["score_masks"] == want_launches
    ref = masks.score_masks_plain(scores, thr, maps,
                                  None if base is None else [m.clone() for m in base])
    for i, (g, r) in enumerate(zip(got, ref)):
        assert torch.equal(g, r), f"layer {i}"
        assert int(g.view(torch.uint8).max()) <= 1
    assert int(got[0].sum()) > 0
    assert torch.equal(masks.score_masks_twin(scores, thr, maps, base)[0], ref[0])


@pytest.mark.parametrize("kind", mask_cases.KINDS)
def test_score_masks_cuda_matches_plain_on_synthetic_scores(cuda, kind):
    """Kernel score_masks bit for bit against the plain version on score
    maps no Harris frame gives (``tests/_mask_cases.py``): int32 values at
    both ends of the range (the kernel's int64 sums and C-truncated axis
    terms at large magnitudes), wide ties, and all-negative maps, where the
    zero fill decides every 3-D check; thresholds INT32_MIN, 0 and 5. One
    launch each."""
    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.detect import scale_space
    from ethzasl_brisk_tpu_torch.kernels import masks

    scores = [torch.from_numpy(s).to(cuda) for s in mask_cases.synthetic_scores(kind)]
    maps = [(scale_space.layer_geometry(i).above_map, scale_space.layer_geometry(i).below_map)
            for i in range(len(scores))]
    for thr in mask_cases.THRESHOLDS:
        _kernels.reset_launches()
        got = masks.score_masks_cuda(scores, thr, maps)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["score_masks"] == 1
        ref = masks.score_masks_plain(scores, thr, maps)
        for i, (g, r) in enumerate(zip(got, ref)):
            assert torch.equal(g, r), f"thr {thr}, layer {i}"
            assert int(g.view(torch.uint8).max()) <= 1
    assert any(int(g.sum()) for g in masks.score_masks_cuda(scores, -(2**31), maps))


def test_score_masks_cuda_rejects_bad_tables(cuda):
    from ethzasl_brisk_tpu_torch.kernels import masks

    sc = torch.zeros((2, 20, 30), dtype=torch.int32, device=cuda)
    maps = [((4, -1, 6), (12, 2, 9)), ((6, -1, 8), (24, 3, 16))]
    with pytest.raises(ValueError, match="int32"):
        masks.score_masks_cuda([sc, sc[:1]], 0, maps)
    with pytest.raises(ValueError, match="int32"):
        masks.score_masks_cuda([sc, sc.float()], 0, maps)
    with pytest.raises(ValueError, match="base mask"):
        masks.score_masks_cuda([sc, sc], 0, maps, [sc.bool(), sc.bool()[:, :5]])
    # An above map that does not shrink leaves the staged footprint and the
    # 4 x 4 patch: the entry refuses it.
    with pytest.raises(RuntimeError, match="launch failed"):
        masks.score_masks_cuda([sc, sc], 0, [((8, -1, 6), (12, 2, 9)), maps[1]])


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


KP_NAMES = ("x", "y", "size", "angle", "response", "octave", "valid")


def _candidate_case(kind: str, dev):
    scores, masks, caps = candidate_cases.case(kind)
    return ([torch.from_numpy(s).to(dev) for s in scores],
            [torch.from_numpy(m).to(dev) for m in masks], caps)


@pytest.mark.parametrize("cluster", [None, 1, 2, 4, 8, 16], ids=lambda c: f"C{c or 'plan'}")
@pytest.mark.parametrize("route", ["auto", "device"])
@pytest.mark.parametrize("kind", candidate_cases.KINDS)
def test_layer_candidates_cuda_matches_plain(cuda, kind, route, cluster):
    """Kernel layer_candidates bit for bit against the plain version on the
    synthetic maps (``tests/_candidate_cases.py``: no mask bit, every pixel
    at the sentinel, survivors past the cap, the whole map, ties,
    masked-in INT32_MIN, float signed zeros and spreads, a long list, long
    tie runs the cap cuts), on the route the plan picks and on the
    device-memory route, at the plan's cluster and at each size forced
    (C = 1 included); one launch each, the counts too, and each list's
    radix passes run and skipped as the twin finds them."""
    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.kernels import candidates as kc

    scores, masks, caps = _candidate_case(kind, cuda)
    routes = None if route == "auto" else ["device"] * len(scores)
    passes = torch.full((scores[0].shape[0], len(scores)), -1, dtype=torch.int32, device=cuda)
    _kernels.reset_launches()
    got, counts = kc.layer_candidates_cuda(scores, masks, caps, routes, cluster, passes)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["layer_candidates"] == 1
    ref, ref_counts = kc.layer_candidates_plain(scores, masks, caps)
    assert torch.equal(counts, ref_counts)
    for i, (g, r) in enumerate(zip(got, ref)):
        for name, a, b in zip(("xs", "ys", "scores", "valid"), g, r):
            assert torch.equal(_bits(a), _bits(b)), f"{kind} layer {i} {name}"
    twin_passes = []
    kc.layer_candidates_twin(scores, masks, caps, cluster, twin_passes)
    assert torch.equal(passes.cpu(), torch.stack(twin_passes, dim=1))


@pytest.mark.parametrize("cluster", [None, 1], ids=["plan", "C1"])
@pytest.mark.parametrize("fused", [False, True], ids=["default", "fused"])
def test_layer_candidates_cuda_on_the_step_layers(cuda, fused, cluster):
    """The B=16 step's four VGA layers at the main path's caps
    (10240/3072/3072/1024, all on the shared-memory route at the plan's
    cluster of 4), and on the device-memory route, at the plan's cluster
    and at C = 1: bitwise against plain, one launch each."""
    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.detect import scale_space
    from ethzasl_brisk_tpu_torch.kernels import candidates as kc

    cfg = scale_space.DetectorConfig(octaves=2, absolute_threshold=20.0, fused_mask=fused)
    frames = torch.from_numpy(bench_frames(16)).to(cuda)
    scores, masks = scale_space.layer_score_masks(scale_space.build_pyramid(frames, 4), cfg)
    caps = [10240, 3072, 3072, 1024]
    assert kc.cluster_size(16, 4, 480 * 640) == 4
    assert [kc.layer_route(c, 4) for c in caps] == ["shared"] * 4
    ref, ref_counts = kc.layer_candidates_plain(scores, masks, caps)
    for routes in (None, ["device"] * 4):
        _kernels.reset_launches()
        got, counts = kc.layer_candidates_cuda(scores, masks, caps, routes, cluster)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["layer_candidates"] == 1
        assert torch.equal(counts, ref_counts)
        for g, r in zip(got, ref):
            for a, b in zip(g, r):
                assert torch.equal(a, b)
    assert int(ref_counts[:, 0].max()) < caps[0]


@pytest.mark.parametrize("what", ["noise", "flat", "every pixel"])
def test_layer_candidates_cuda_on_a_vga_map(cuda, what):
    """One VGA layer a detection, as the quick start and the whole-map
    lists give it, on the plan's cluster of 16: a noise frame's layer at a
    cap over its survivors (the shared route), the whole map of a flat
    frame (every fill, the device route) and of one whose every pixel
    survives at 18,432 (the radix select over the cluster) and at k = h*w
    (the device route's sort of 307,200 keys); bitwise against plain."""
    from ethzasl_brisk_tpu_torch.detect import scale_space
    from ethzasl_brisk_tpu_torch.kernels import candidates as kc

    assert kc.cluster_size(1, 1, 480 * 640) == 16
    if what == "every pixel":
        sc = torch.randint(-(2**31) + 1, 2**31 - 1, (1, 480, 640), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(23)).to(cuda)
        sc[0, 100:300, 50:600] = 12345  # a long tie run the cap cuts
        layers, caps = ([sc], [torch.ones_like(sc, dtype=torch.bool)]), [18432, 480 * 640]
    else:
        frame = torch.from_numpy(bench_frames(1)).to(cuda)
        if what == "flat":
            frame[:] = 77
        cfg = scale_space.DetectorConfig(octaves=0, absolute_threshold=20.0)
        layers = scale_space.layer_score_masks(scale_space.build_pyramid(frame, 1), cfg)
        caps = [18432] if what == "noise" else [480 * 640]
    for cap in caps:
        ref, ref_counts = kc.layer_candidates_plain(*layers, [cap])
        for routes in (None, ["device"]):
            if routes is None and kc.layer_route(cap, 16) != "shared":
                continue
            got, counts = kc.layer_candidates_cuda(*layers, [cap], routes)
            torch.cuda.synchronize()
            assert torch.equal(counts, ref_counts)
            for a, b in zip(got[0], ref[0]):
                assert torch.equal(a, b), (what, cap, routes)


def test_layer_candidates_cuda_rejects_bad_tables(cuda):
    from ethzasl_brisk_tpu_torch.kernels import candidates as kc

    sc = torch.zeros((2, 20, 30), dtype=torch.int32, device=cuda)
    m = torch.ones((2, 20, 30), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        kc.layer_candidates_cuda([sc, sc[:1]], [m, m[:1]], [5, 5])
    with pytest.raises(ValueError, match="mask"):
        kc.layer_candidates_cuda([sc], [m[:, :5]], [5])
    with pytest.raises(ValueError, match="route"):
        kc.layer_candidates_cuda([sc], [m], [600], ["nowhere"])
    with pytest.raises(ValueError, match="int32 or float32"):
        kc.layer_candidates_cuda([sc.double()], [m], [5])
    with pytest.raises(ValueError, match="cluster"):
        kc.layer_candidates_cuda([sc], [m], [5], None, 3)
    big = torch.zeros((1, 200, 300), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="route"):
        kc.layer_candidates_cuda([big], [big.bool()], [60000], ["shared"], 8)
    with pytest.raises(ValueError, match="passes"):
        kc.layer_candidates_cuda([sc], [m], [5], passes=torch.zeros(2, 2, dtype=torch.int32,
                                                                     device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("kind", candidate_cases.REFINE_KINDS)
def test_refine_keypoints_cuda_matches_plain(cuda, kind, dtype):
    """Kernel refine_keypoints bit for bit against the plain version on the
    synthetic maps' candidate lists (``long_list``: rows past two of the
    kernel's chunks, one of them 4 bytes into a 16-byte word), with no
    accept, every accept, half and accepts only in the last 1,024 flags,
    caps of k (no compaction), k / 2 and 3 (on the long list 64 and one
    past a chunk's slot table): every KeyPoints field and the accepted
    counts, one launch each; the kernel's torch twin on the card too; and
    the last case again on strided inputs (``_strided``), which the wrapper
    copies to contiguous ones."""
    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.detect import refine, scale_space
    from ethzasl_brisk_tpu_torch.kernels import candidates as kc

    scores, masks, caps = _candidate_case(kind, cuda)
    cands, _ = kc.layer_candidates_plain(scores, masks, caps)
    cands = [tuple(t.contiguous() for t in c) for c in cands]
    geoms = [scale_space.layer_geometry(i) for i in range(len(scores))]
    layer_caps = [candidate_cases.refine_caps(kind, c[0].shape[1], refine.CHUNK) for c in cands]
    for accept_kind in candidate_cases.ACCEPT_KINDS:
        accepts = [torch.from_numpy(candidate_cases.accepts_for(c[3].cpu().numpy(), accept_kind,
                                                                i)).to(cuda)
                   for i, c in enumerate(cands)]
        for rcaps in zip(*layer_caps):
            rcaps = list(rcaps)
            ref, ref_counts = refine.refine_keypoints_plain(scores, cands, accepts, rcaps, geoms,
                                                            dtype)
            twin, twin_counts = refine.refine_keypoints_twin(scores, cands, accepts, rcaps, geoms,
                                                             dtype)
            assert torch.equal(twin_counts, ref_counts)
            for name, t, b in zip(KP_NAMES, twin.fields(), ref.fields()):
                assert torch.equal(_bits(t), _bits(b)), f"twin {kind} {accept_kind} {rcaps} {name}"
            _kernels.reset_launches()
            got, counts = refine.refine_keypoints_cuda(scores, cands, accepts, rcaps, geoms, dtype)
            torch.cuda.synchronize()
            assert _kernels.LAUNCHES["refine_keypoints"] == 1
            assert torch.equal(counts, ref_counts)
            for name, a, b in zip(KP_NAMES, got.fields(), ref.fields()):
                assert torch.equal(_bits(a), _bits(b)), f"{kind} {accept_kind} {rcaps} {name}"
    strided = ([_strided(sc) for sc in scores], [tuple(_strided(t) for t in c) for c in cands],
               [_strided(a) for a in accepts])
    assert not (strided[0][0].is_contiguous() or strided[1][0][0].is_contiguous()
                or strided[2][0].is_contiguous())
    _kernels.reset_launches()
    got, counts = refine.refine_keypoints_cuda(*strided, rcaps, geoms, dtype)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["refine_keypoints"] == 1
    assert torch.equal(counts, ref_counts)
    for name, a, b in zip(KP_NAMES, got.fields(), ref.fields()):
        assert torch.equal(_bits(a), _bits(b)), f"strided {kind} {rcaps} {name}"


def _strided(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a tensor that is not contiguous: a (B, h, w) map
    transposed twice over a transposed copy, a (B, k) list every other
    column of one twice as wide."""
    if t.dim() == 3:
        return t.transpose(1, 2).contiguous().transpose(1, 2)
    wide = torch.zeros((t.shape[0], 2 * t.shape[1]), dtype=t.dtype, device=t.device)
    wide[:, ::2] = t
    return wide[:, ::2]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_detect_keypoints_on_card_matches_cpu(cuda, dtype):
    """The whole detection on the card (K1, score_masks, layer_candidates,
    enforce_uniformity, refine_keypoints: one launch each) against the CPU:
    every KeyPoints field and the certificate bit for bit."""
    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.detect import scale_space

    cfg = scale_space.DetectorConfig(**{k: v for k, v in STEP_CONFIG.items()
                                        if k != "describe_capacity"}, refine_dtype=dtype)
    frames = torch.from_numpy(bench_frames(4, 240, 320, seed=4))
    _kernels.reset_launches()
    got, gdiag = scale_space.detect_keypoints(frames.to(cuda), cfg, with_diagnostics=True)
    torch.cuda.synchronize()
    for name in ("harris_score_i32", "score_masks", "layer_candidates", "enforce_uniformity",
                 "refine_keypoints"):
        assert _kernels.LAUNCHES[name] == 1, name
    ref, rdiag = scale_space.detect_keypoints(frames, cfg, with_diagnostics=True)
    for a, b in zip(got.fields(), ref.fields()):
        assert torch.equal(_bits(a).cpu(), _bits(b))
    for a, b in zip(gdiag, rdiag):
        assert torch.equal(a.cpu(), b)
    assert int(ref.valid.sum()) > 100


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
    assert _kernels.LAUNCHES["score_masks"] == 1  # one launch for the 4 layers
    assert _kernels.LAUNCHES["smoothed_intensity"] == 0  # both samplings are describe_rotated's
    assert _kernels.LAUNCHES["describe_rotated"] == 1
    assert _kernels.LAUNCHES["brisk_orientation"] == 0
    assert _kernels.LAUNCHES["enforce_uniformity"] == 1  # one launch for the 4 layers
    assert _kernels.LAUNCHES["layer_candidates"] == _kernels.LAUNCHES["refine_keypoints"] == 1
    assert _kernels.LAUNCHES["pyramid_u8"] == 1  # layers 1-3
    assert _kernels.LAUNCHES["hamming_argmin"] == 1  # both pairs
    ref = FramePipeline(BriskFeature(**STEP_CONFIG, device="cpu"), device="cpu").step(frames)
    assert torch.equal(got[0].valid.cpu(), ref[0].valid)
    assert torch.equal(got[0].response.cpu(), ref[0].response)
    for i, what in ((1, "descriptors"), (2, "match index"), (3, "match distance")):
        assert torch.equal(got[i].cpu(), ref[i]), what


def test_fused_step_launches_k3_and_equals_default(cuda):
    """fused_mask=True: K3 once for the four layers, K1 never,
    describe_rotated, pyramid_u8 and hamming_argmin once and K2 never;
    every output bit-equal to the default step on the card."""
    from ethzasl_brisk_tpu_torch import FramePipeline, _kernels

    frames = torch.from_numpy(bench_frames(3, 120, 160)).to(cuda)
    default = FramePipeline(BriskFeature(**STEP_CONFIG, device="cuda"), device="cuda").step(frames)
    _kernels.reset_launches()
    fused = FramePipeline(BriskFeature(**STEP_CONFIG, fused_mask=True, device="cuda"),
                          device="cuda").step(frames)
    assert _kernels.LAUNCHES["harris_score_mask"] == 1
    assert _kernels.LAUNCHES["harris_score_i32"] == 0
    assert _kernels.LAUNCHES["score_masks"] == 1  # the 3-D checks on K3's masks
    assert _kernels.LAUNCHES["smoothed_intensity"] == 0
    assert _kernels.LAUNCHES["describe_rotated"] == 1
    assert _kernels.LAUNCHES["enforce_uniformity"] == 1
    assert _kernels.LAUNCHES["layer_candidates"] == _kernels.LAUNCHES["refine_keypoints"] == 1
    assert _kernels.LAUNCHES["pyramid_u8"] == _kernels.LAUNCHES["hamming_argmin"] == 1
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
    """The AST step on the card: describe_rotated, pyramid_u8 and
    hamming_argmin once, K1, K2 and K3 never; its outputs against the same
    step on the CPU."""
    from ethzasl_brisk_tpu_torch import AstFramePipeline, BriskFeatureDetector, _kernels

    frames = torch.from_numpy(bench_frames(3, 160, 212, seed=5))
    cfg = dict(AST_CONFIG, raw_cache_model=model)
    pipe = AstFramePipeline(BriskFeatureDetector(**cfg, device="cuda"), device="cuda",
                            describe_capacity=200)
    _kernels.reset_launches()
    got = pipe.step(frames)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["smoothed_intensity"] == 0
    assert _kernels.LAUNCHES["describe_rotated"] == 1
    assert _kernels.LAUNCHES["harris_score_i32"] == _kernels.LAUNCHES["harris_score_mask"] == 0
    assert _kernels.LAUNCHES["score_masks"] == 0
    assert _kernels.LAUNCHES["layer_candidates"] == _kernels.LAUNCHES["refine_keypoints"] == 0
    assert _kernels.LAUNCHES["pyramid_u8"] == _kernels.LAUNCHES["hamming_argmin"] == 1
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
    """``BriskFeatureDetector(version="v1")`` on the card: describe_rotated's
    v1 variant once, K2 never; every field, the angle included, and every descriptor bit for
    bit against the CPU."""
    from ethzasl_brisk_tpu_torch import BriskFeatureDetector, _kernels

    frame = torch.from_numpy(bench_frames(1, 160, 212, seed=5)[0])
    cfg = dict(threshold=35, octaves=3, max_candidates_per_layer=512, version="v1")
    _kernels.reset_launches()
    got = BriskFeatureDetector(**cfg, device="cuda").detect_and_compute(frame)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["smoothed_intensity_v1"] == 0
    assert _kernels.LAUNCHES["describe_rotated_v1"] == 1
    assert _kernels.LAUNCHES["smoothed_intensity"] == _kernels.LAUNCHES["describe_rotated"] == 0
    ref = BriskFeatureDetector(**cfg, device="cpu").detect_and_compute(frame)
    assert got[1].shape == (got[0].capacity, 16) and int(ref[0].valid.sum()) > 20
    kg, kc = got[0], ref[0]
    for name in ("x", "y", "size", "angle", "response", "octave", "valid"):
        assert torch.equal(getattr(kg, name).cpu(), getattr(kc, name)), name
    assert torch.equal(got[1].cpu(), ref[1])


def test_camera_grid_on_card_matches_cpu(cuda):
    """The camera-aware grid on the card: K1 once, describe_rotated once (v2
    rounding), K2 never, the walk-back kernel once and the elementwise angle kernels never;
    keypoints, the angle included, and
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
    assert _kernels.LAUNCHES["smoothed_intensity"] == 0
    assert _kernels.LAUNCHES["describe_rotated"] == 1
    assert _kernels.LAUNCHES["smoothed_intensity_v1"] == 0
    assert _kernels.LAUNCHES["brisk_orientation"] == 0
    assert _kernels.LAUNCHES["walk_angles"] == 1
    assert _kernels.LAUNCHES["atan2f_elementwise"] == _kernels.LAUNCHES["sincosf_elementwise"] == 0
    assert _kernels.LAUNCHES["score_masks"] == 1  # octaves 0: the 2-D mask alone
    assert _kernels.LAUNCHES["layer_candidates"] == _kernels.LAUNCHES["refine_keypoints"] == 1
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
    (the card's Sampson scores, projections and refinement differ from the
    CPU's in the last digits) and
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


def _describe_inputs(kind, k, b, h, w, seed=18):
    """A pattern of ``kind`` and a ``describe_rotated`` call's inputs after
    the pattern on the CPU: K keypoints over B frames, some whose pattern
    leaves the frame, half with given angles one ULP around the bin edges
    beside computed ones, the integral and the flags."""
    import dataclasses

    from ethzasl_brisk_tpu_torch.core.pattern import brisk_v1_pattern
    from ethzasl_brisk_tpu_torch.describe.extractor import DevicePattern

    rng = np.random.default_rng(seed)
    v1 = kind == "v1"
    host = (brisk_v1_pattern() if v1 else brisk_v2_pattern(0.5 if kind == "v2_half" else 1.0))
    pat = DevicePattern.from_host(host)
    if kind == "subset":
        pat = dataclasses.replace(
            pat, short_i=pat.short_i[:300].clone(), short_j=pat.short_j[:300].clone(),
            long_i=pat.long_i[::2].clone(), long_j=pat.long_j[::2].clone(),
            long_wdx=pat.long_wdx[::2].clone(), long_wdy=pat.long_wdy[::2].clone())
    imgs = torch.from_numpy(bench_frames(b, h, w, seed=seed))
    sizes = torch.from_numpy(rng.choice([6.0, 8.0, 12.0, 24.0, 54.0], k).astype(np.float32))
    edges = ((np.arange(-1024, 1024) - 0.5) * 360.0 / 1024).astype(np.float32).view(np.int32)
    near = np.concatenate([(edges + d).view(np.float32) for d in (-1, 0, 1)])
    angle = np.where(rng.random(k) < 0.5, rng.choice(near, k), np.float32(-1.0))
    key_x = torch.from_numpy(rng.uniform(-5, w + 5, k).astype(np.float32))
    key_y = torch.from_numpy(rng.uniform(-5, h + 5, k).astype(np.float32))
    row_base = torch.from_numpy(rng.integers(0, b, k).astype(np.int32) * (h + 1))
    args = (_stack_frames(imgs), h, scale_index(sizes), torch.from_numpy(rng.random(k) < 0.8),
            torch.from_numpy(angle.astype(np.float32)), key_x, key_y, row_base, v1)
    return pat, args


def _describe_on_card(pat, args, rotate, cuda):
    """``describe_rotated_cuda`` on the card and ``describe_rotated_plain`` on
    the CPU for the same inputs, and the launches of the card's call."""
    import dataclasses

    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.describe.extractor import DevicePattern
    from ethzasl_brisk_tpu_torch.describe.rotated import describe_rotated_cuda, describe_rotated_plain

    integral, h, *rest = args
    pat_gpu = DevicePattern(**{f.name: getattr(pat, f.name).to(cuda)
                               for f in dataclasses.fields(pat)})
    _kernels.reset_launches()
    got = describe_rotated_cuda(pat_gpu, integral.to(cuda), h, rotate,
                                *(a.to(cuda) if torch.is_tensor(a) else a for a in rest))
    torch.cuda.synchronize()
    counted = {n: c for n, c in _kernels.LAUNCHES.items() if c}
    return got, describe_rotated_plain(pat, integral, h, rotate, *rest), counted


@pytest.mark.parametrize("rotate", [True, False])
@pytest.mark.parametrize("kind", ["v2", "v1", "v2_half", "subset"])
def test_describe_rotated_kernel_matches_plain(cuda, kind, rotate):
    """Kernel ``describe_rotated`` against its plain version on the CPU, bit
    for bit (angle and words), one launch counted under its variant: the
    v2 and v1 patterns (v1 rounding), v2 at pattern scale 0.5 (the bilinear
    branch live), a pattern of 300 short and 428 long pairs (a partial last
    word); keypoints whose pattern leaves the frame, given angles one ULP
    around the bin edges beside computed ones; without rotation invariance,
    theta 0 and the given angle."""
    k = 700
    pat, args = _describe_inputs(kind, k, 3, 120, 160)
    v1 = kind == "v1"
    got, ref, counted = _describe_on_card(pat, args, rotate, cuda)
    assert counted == {"describe_rotated_v1" if v1 else "describe_rotated": 1}, counted
    assert torch.equal(got[0].cpu().view(torch.int32), ref[0].view(torch.int32))
    assert torch.equal(got[1].cpu(), ref[1])
    assert got[1].shape == (k, 16 if v1 else 12) and int((ref[1] != 0).sum()) > k


@pytest.mark.parametrize("k", [1, 300, 2000, 10240])
def test_describe_rotated_kernel_tiles(cuda, k):
    """The kernel's tile follows K: one keypoint, a K below one wave of
    resident CTAs (small tiles), a middle one, and the B=16 step's 10,240
    slots on VGA frames (the largest tile over a persistent grid); each
    bitwise against the plain version, angle and words."""
    b = 16 if k == 10240 else 2
    pat, args = _describe_inputs("v2", k, b, 480, 640, seed=19)
    got, ref, counted = _describe_on_card(pat, args, True, cuda)
    assert counted == {"describe_rotated": 1}, counted
    assert torch.equal(got[0].cpu().view(torch.int32), ref[0].view(torch.int32))
    assert torch.equal(got[1].cpu(), ref[1]) and got[1].shape == (k, 12)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segment_sums_kernel_matches_plain(cuda, dtype):
    """Kernel ``segment_sums`` on a Gauss-Newton step's five sums at the
    VO window's widths and lengths (8 keyframes of ~600 rows, 1,500
    landmarks of ~3, 12,000 mostly empty (landmark, keyframe) segments,
    padded rows dropped): one launch, each sum bit for bit the CPU's
    ``index_add_``; twice the same."""
    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.ba.segment import segment_plan, segment_sum_plain, segment_sums

    rng = np.random.default_rng(21)
    k, n_lm, o = 8, 1500, 5200
    kf, lm = rng.integers(0, k, o), rng.integers(0, n_lm, o)
    kf[4800:], lm[4800:] = -1, -1   # the padded slots
    plans = [segment_plan(torch.from_numpy(i), n) for i, n in
             ((kf, k), (lm, n_lm), (np.where(kf >= 0, lm * k + kf, -1), n_lm * k))]
    cols = [(36, 0), (9, 1), (6, 0), (3, 1), (18, 2)]
    values = [torch.from_numpy(rng.normal(0, 1, (o, w)) * 10.0 ** rng.integers(-5, 5, (o, w)))
              .to(dtype) for w, _ in cols]
    ref = [segment_sum_plain(v, plans[p]) for v, (_, p) in zip(values, cols)]
    on_card = [segment_plan(p.key.to(cuda), p.n) for p in plans]
    items = [(v.to(cuda), on_card[p]) for v, (_, p) in zip(values, cols)]
    _kernels.reset_launches()
    got = [segment_sums(items) for _ in range(2)]
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["segment_sum"] == 2
    for g0, g1, r in zip(*got, ref):
        assert torch.equal(g0.cpu(), r) and torch.equal(g1, g0)


def _same_angles(got, ref):
    """Bit for bit where not NaN (the card's NaN is canonical), NaN where NaN."""
    got = got.cpu()
    nan = ref.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got[~nan].view(torch.int32), ref[~nan].view(torch.int32))


@pytest.mark.parametrize("mode", ["angle", "direction"])
def test_walk_angles_kernel_matches_plain(cuda, mode):
    """Kernel ``walk_angles`` against ``walk_angles_plain`` on the CPU: the
    grid's walk back (a view angle) and the extraction direction's tail
    (a direction), over nine views' maps, keypoints on and off them, NaN
    and huge lanes; strided inputs as the grid passes them; one launch."""
    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.geometry.camera_aware import walk_angles, walk_angles_plain

    rng = np.random.default_rng(4)
    k, f = 6000, np.float32
    maps = torch.from_numpy(np.stack(np.meshgrid(np.arange(187), np.arange(160)), -1)[None]
                            .repeat(9, 0).astype(f) * 1.3 + rng.normal(0, 2, (9, 160, 187, 2))
                            .astype(f))
    pts = rng.uniform(-20, 200, (k, 2)).astype(f)
    ref_xy = rng.uniform(-10, 250, (k, 2)).astype(f)
    size = rng.uniform(4, 60, k).astype(f)
    step = (rng.uniform(-1, 360, k) if mode == "angle" else rng.normal(0, 1, (k, 2))).astype(f)
    for a in (pts[:, 0], size, step.reshape(k, -1)[:, 0]):
        a[rng.integers(0, k, 50)] = np.nan
        a[rng.integers(0, k, 50)] = f(3e9)
        a[rng.integers(0, k, 50)] = f(-3e9)
    vidx = torch.from_numpy(rng.integers(0, 9, k).astype(np.int32))
    pts, ref_xy, size, step = map(torch.from_numpy, (pts, ref_xy, size, step))

    def run(dev, fn):
        p, r, st = pts.to(dev), ref_xy.to(dev), step.to(dev)
        kw = dict(angle=st) if mode == "angle" else dict(direction=(st[:, 0], st[:, 1]))
        return fn(maps.to(dev), vidx.to(dev), p[:, 0], p[:, 1], size.to(dev), r[:, 0], r[:, 1],
                  **kw)

    ref = run("cpu", walk_angles_plain)
    _kernels.reset_launches()
    got = run(cuda, walk_angles)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["walk_angles"] == 1
    assert _kernels.LAUNCHES["atan2f_elementwise"] == _kernels.LAUNCHES["sincosf_elementwise"] == 0
    _same_angles(got, ref)
    assert int(ref.isfinite().sum()) > k - 600


def test_add_latency_probe(cuda):
    """The dependent-add latency behind segment_sum's chain bound: a few
    SM cycles an add, float64 no faster than float32."""
    from ethzasl_brisk_tpu_torch import _kernels, measure

    _kernels.reset_launches()
    f32, f64 = (measure.add_latency_cycles(cuda, t) for t in (torch.float32, torch.float64))
    assert 1.0 <= f32 <= 64.0 and f32 <= f64 <= 64.0, (f32, f64)
    assert _kernels.LAUNCHES["add_latency"] == 6


@pytest.mark.parametrize("name", UNIFORMITY_CASES)
def test_uniformity_kernel_matches_plain(cuda, name):
    """Kernel ``enforce_uniformity`` on each route it can take for the
    problem (the grid where the layer's grid fits, its candidates staged as
    the wrapper stages them: in shared memory for the case's few problems
    where they fit, in device memory for the case's problems repeated past
    the card's SM count; the candidates route always) against every plain
    version, the blocked one on the CPU and on the card and the grid and
    scan twins on the CPU, bit for bit, over the CPU parity tests'
    problems; one launch a call; each CTA's rounds between its accepts and
    its accepts plus its windows."""
    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.detect.uniformity import launch_staging

    xs, ys, scores, valid, rows, cols, radius, cap = uniformity_case(name)
    args = [torch.from_numpy(a) for a in (xs, ys, scores, valid)]
    kw = dict(radius=radius, max_num_kpt=cap)
    k = xs.shape[1]
    ref = enforce_uniformity_plain(*args, **kw)
    assert torch.equal(ref, enforce_uniformity_scan_plain(*args, **kw))
    assert torch.equal(ref, enforce_uniformity_grid_plain(*args, rows=rows, cols=cols, **kw))
    assert torch.equal(ref.to(cuda), enforce_uniformity_plain(*(a.to(cuda) for a in args), **kw))
    grid_fits = layer_plan(k, (rows, cols), radius)[0] == "grid"
    assert grid_fits == (name != "r10_vga_candidates")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    wide = np.arange(sms + 1) % xs.shape[0]  # more CTAs than SMs: device-staged
    runs = [("candidates", None)] + ([("auto", None), ("auto", wide)] if grid_fits else [])
    for route, rows_ in runs:
        a_, ref_ = (args, ref) if rows_ is None else ([a[rows_] for a in args], ref[rows_])
        problems = [(*(a.to(cuda) for a in a_), cap)]
        assert launch_staging(problems) == ("shared" if rows_ is None else "device")
        _kernels.reset_launches()
        (got,), rounds = enforce_uniformity_cuda(problems, radius=radius, shapes=[(rows, cols)],
                                                 rounds=True, route=route)
        torch.cuda.synchronize()
        run = (route, "shared" if rows_ is None else "device")
        assert _kernels.LAUNCHES["enforce_uniformity"] == 1
        assert torch.equal(got.cpu(), ref_), run
        acc = ref_.sum(dim=1).to(torch.int32)
        assert bool((rounds.cpu() >= acc).all()), run
        assert bool((rounds.cpu() <= acc + -(-k // WINDOW)).all()), run


def test_uniformity_kernel_layers_in_one_launch(cuda):
    """Four problem sets of one radius in one launch, the routes mixed:
    three on the grid (the last with more candidates than fit beside its
    grid, so staged in device memory), one on the candidates route for want
    of a shape; each set's mask bitwise its plain version."""
    from ethzasl_brisk_tpu_torch import _kernels

    names = ["r30_int_cap1", "no_valid_first_invalid", "straddle", "beyond_shared_memory"]
    sets = [uniformity_case(n) for n in names]
    assert {s[6] for s in sets} == {30.0}
    host = [([torch.from_numpy(a) for a in s[:4]], s[7]) for s in sets]
    shapes = [s[4:6] for s in sets]
    shapes[1] = None
    plans = [layer_plan(s[0].shape[1], shape, 30.0) for s, shape in zip(sets, shapes)]
    assert [p[0] for p in plans] == ["grid", "candidates", "grid", "grid"]
    assert [p[3] for p in plans] == [True, True, True, False]
    _kernels.reset_launches()
    got = enforce_uniformity_cuda([(*(a.to(cuda) for a in args), cap) for args, cap in host],
                                  radius=30.0, shapes=shapes)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["enforce_uniformity"] == 1
    for name, g, (args, cap) in zip(names, got, host):
        assert torch.equal(g.cpu(), enforce_uniformity_plain(*args, radius=30.0, max_num_kpt=cap)), name


def test_uniformity_kernel_makes_no_host_sync(cuda):
    """``enforce_uniformity_cuda`` on the B=16 step's layer shapes under
    ``torch.cuda.set_sync_debug_mode("error")``, on the grid route (the
    layers' shapes given) and on the candidates route: no call of the
    wrapper synchronises the host (after one warm call that builds the
    library)."""
    from ethzasl_brisk_tpu_torch.detect import scale_space
    from ethzasl_brisk_tpu_torch.kernels.candidates import layer_candidates

    frames = torch.from_numpy(bench_frames(4)).to(cuda)
    feature = BriskFeature(**STEP_CONFIG, device="cuda")
    cfg = feature.config
    scores, masks = scale_space.layer_score_masks(scale_space.build_pyramid(frames, 4), cfg)
    cands, _ = layer_candidates(scores, masks, [cfg.layer_cap(i) for i in range(4)])
    problems = [(*c, min(cfg.max_num_kpt, c[0].shape[1])) for c in cands]
    shapes = [tuple(sc.shape[-2:]) for sc in scores]
    assert all(layer_plan(p[0].shape[1], s, 30.0)[0] == "grid" for p, s in zip(problems, shapes))
    for route in ("auto", "candidates"):
        enforce_uniformity_cuda(problems, radius=30.0, shapes=shapes, route=route)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = enforce_uniformity_cuda(problems, radius=30.0, shapes=shapes, route=route)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for g, (xs, ys, sc, v, cap) in zip(got, problems):
            assert torch.equal(g, enforce_uniformity_plain(xs, ys, sc, v, radius=30.0,
                                                           max_num_kpt=cap)), route


def test_round_latency_probe(cuda):
    """The round latency behind enforce_uniformity's chain bound: a round
    (a shared read, a ballot, a barrier, a reduction) takes tens to a few
    hundred SM cycles."""
    from ethzasl_brisk_tpu_torch import _kernels, measure

    _kernels.reset_launches()
    cycles = measure.round_latency_cycles(cuda)
    assert 10.0 <= cycles <= 2000.0, cycles
    assert _kernels.LAUNCHES["round_latency"] == 3


VO_STEP = 11  # the stressed synthetic scene's step where the card once took another translation


def _shared_draw(seed: int):
    """RANSAC draws that hand the card and the CPU the same samples (as
    ``chip_smoke.py``'s ``shared_draw``)."""
    from ethzasl_brisk_tpu_torch.geometry.ransac import sample_indices

    gen = torch.Generator().manual_seed(seed)

    def draw(n_hyp, k, weights):
        u = torch.rand((n_hyp, k), generator=gen, dtype=torch.float64)
        return sample_indices(u.to(weights.device), weights)
    return draw


def _recorded_vo_steps(frames, device):
    """``vo.synthetic``'s stressed run on ``device`` with the shared draws:
    its poses and, for each step, the pixels its rays came from and the
    inputs and outputs of its RANSAC and its decomposition."""
    from ethzasl_brisk_tpu_torch.geometry.cameras import PinholeCamera
    from ethzasl_brisk_tpu_torch.vo import frontend, synthetic

    steps, pixels = [], []
    ransac, decompose = frontend.ransac_essential, frontend.decompose_essential
    unproject = PinholeCamera.unproject

    def rec_unproject(self, kp):
        pixels.append(kp.clone())
        return unproject(self, kp)

    def rec_ransac(*args, **kw):
        out = ransac(*args, **kw)
        steps.append(dict(pixels=pixels[-2:], ransac=(args, kw, out)))
        return out

    def rec_decompose(*args, **kw):
        out = decompose(*args, **kw)
        steps[-1]["decompose"] = (args, out)
        return out

    frontend.ransac_essential, frontend.decompose_essential = rec_ransac, rec_decompose
    PinholeCamera.unproject = rec_unproject
    try:
        poses = synthetic.run(frames, True, device, draw=_shared_draw(3))
    finally:
        frontend.ransac_essential, frontend.decompose_essential = ransac, decompose
        PinholeCamera.unproject = unproject
    return poses, steps


def _svd_sites(card: set, card64: set = frozenset()):
    """A stand-in for ``geometry.ransac._svd`` that runs the RANSAC sites
    named in ``card`` on the card's cuSOLVER, those in ``card64`` on the
    card's cuSOLVER in float64 (the factors rounded to float32), and the
    rest on the host's LAPACK: "hypotheses" (the 8-point systems' null
    vectors, on the host in the port), "refit" (the inlier system's),
    "project" (E onto the essential manifold) and "decompose" (the last
    three on the card in the port)."""
    import sys

    from ethzasl_brisk_tpu_torch.geometry import ransac

    svd = ransac._svd

    def site_svd(a, full_matrices=True, host=False):
        caller = sys._getframe(1).f_code.co_name
        site = {"_null_vector": "hypotheses" if a.dim() == 3 else "refit",
                "_project_essential": "project",
                "decompose_essential": "decompose"}[caller]
        if site in card64:
            return tuple(f.to(a.dtype) for f in svd(a.double(), full_matrices=full_matrices))
        return svd(a, full_matrices=full_matrices, host=site not in card)
    return site_svd


def test_stressed_vo_step_11_matches_the_cpu(cuda, capsys):
    """``vo.synthetic --stress``'s step 11 on the card against the CPU, with
    the same draws. The step's matches, samples and rays (made on the host)
    are bitwise the CPU's, and its translation is the CPU's. The evidence
    for that route is printed: the RANSAC and decomposition on the card
    from the rays the card makes itself or from the host's, with each
    float32 SVD site on the card's cuSOLVER or on the host's LAPACK, and
    the translation each gives beside the CPU's; it takes both the host's
    rays and the host's SVD of the 8-point systems, and no other site. The
    card's own float64 route is printed too: the rays and the 8-point
    systems' null vectors in float64 on the card, rounded to float32."""
    from ethzasl_brisk_tpu_torch.geometry import PinholeCamera, ransac
    from ethzasl_brisk_tpu_torch.vo import synthetic

    frames, _ = synthetic.render_frames(VO_STEP + 1, stress=True)
    est_g, steps_g = _recorded_vo_steps(frames, cuda)
    est_c, steps_c = _recorded_vo_steps(frames, "cpu")
    j = VO_STEP - 1
    (args_g, kw_g, out_g), (args_c, kw_c, out_c) = steps_g[j]["ransac"], steps_c[j]["ransac"]
    for g, c in zip((*args_g[1:4], kw_g["samples"]), (*args_c[1:4], kw_c["samples"])):
        assert torch.equal(g.cpu(), c), "the step's rays, matches or samples differ"
    r_cpu, t_cpu, n_cpu = steps_c[j]["decompose"][1]
    lines = [f"CPU: n_inliers {int(out_c[2])}, in front {int(n_cpu)}, t {t_cpu.tolist()}",
             f"card: n_inliers {int(out_g[2])}, t {steps_g[j]['decompose'][1][1].cpu().tolist()}"]
    cam = PinholeCamera(*synthetic.CAMERA)
    made = {"card": [], "card64": []}
    for name, px, host_ray in zip(("ra", "rb"), steps_g[j]["pixels"], args_g[1:3]):
        for rays, dtype in (("card", torch.float32), ("card64", torch.float64)):
            r3 = cam.unproject(px.to(cuda, dtype))
            made[rays].append((r3[..., :2] / r3[..., 2:3]).to(torch.float32))
            d = (made[rays][-1] - host_ray).abs()
            lines.append(f"{name} made on the card in {dtype}: {int((d > 0).sum())} of "
                         f"{d.numel()} apart from the host's, max {float(d.max()):.3e}")
    made["host"] = list(args_g[1:3])
    sites = ["hypotheses", "refit", "project", "decompose"]
    runs = [(rays, card, ()) for rays in ("card", "host")
            for card in (sites, *[[s] for s in sites], [])]
    runs += [("card64", sites[1:], ("hypotheses",)), ("host", sites[1:], ("hypotheses",))]
    svd = ransac._svd
    for rays, card, card64 in runs:
        ra, rb = made[rays]
        ransac._svd = _svd_sites(set(card), set(card64))
        try:
            e, inl, n_inl = ransac.ransac_essential(None, ra, rb, args_g[3], **kw_g)
            r, t, n_front = ransac.decompose_essential(e, ra, rb, inl)
        finally:
            ransac._svd = svd
        e_gap = min(float((e.cpu() - out_c[0]).abs().max()),
                    float((e.cpu() + out_c[0]).abs().max()))
        lines.append(
            f"{rays} rays, cuSOLVER at {card or 'no site'}"
            f"{', in float64 at ' + str(list(card64)) if card64 else ''}: n_inliers "
            f"{int(n_inl)} (mask equal {bool(torch.equal(inl.cpu(), out_c[1]))}), in front "
            f"{int(n_front)}, |t - t_cpu| {float((t.cpu() - t_cpu).norm()):.3e}, "
            f"|E -+ E_cpu| {e_gap:.3e}")
    rel = [np.linalg.inv(np.asarray(e_[j])) @ np.asarray(e_[j + 1]) for e_ in (est_g, est_c)]
    gap = float(np.linalg.norm(rel[0][:3, 3] - rel[1][:3, 3]))
    lines.append(f"the port's step {VO_STEP}: |t_card - t_cpu| {gap:.3e}")
    with capsys.disabled():
        print("\n[vo step 11] " + "\n[vo step 11] ".join(lines))
    assert gap < 1e-3, lines


def test_uniformity_launch_staging_follows_the_sm_count(cuda):
    """A launch with more CTAs than the card has SMs stages its grid-route
    candidates in device memory, one that fits stages them in shared
    memory; both bitwise the blocked plain version."""
    from ethzasl_brisk_tpu_torch.detect.uniformity import launch_staging

    xs, ys, scores, valid, rows, cols, radius, cap = uniformity_case("r30_int_cap1")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for n, want in ((sms, "shared"), (sms + 1, "device")):
        rows_ = np.arange(n) % xs.shape[0]
        args = [torch.from_numpy(a[rows_]) for a in (xs, ys, scores, valid)]
        problems = [(*(a.to(cuda) for a in args), 40)]
        assert launch_staging(problems) == want
        (got,) = enforce_uniformity_cuda(problems, radius=radius, shapes=[(rows, cols)])
        assert torch.equal(got.cpu(), enforce_uniformity_plain(*args, radius=radius,
                                                               max_num_kpt=40)), want


def _match_on_card(cuda, words, valid, n_bits):
    """Kernel hamming_argmin against its plain version on the same words,
    bit for bit, and its launches (one a call, none for B < 2)."""
    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.match.matcher import match_adjacent, match_adjacent_plain

    d = torch.from_numpy(np.ascontiguousarray(words).view(np.int32))
    v = torch.from_numpy(valid)
    _kernels.reset_launches()
    got = match_adjacent(d.to(cuda), v.to(cuda), n_bits=n_bits)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["hamming_argmin"] == (1 if words.shape[0] > 1 else 0)
    ref = match_adjacent_plain(d, v, n_bits=n_bits)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32 and g.device.type == "cuda"
        assert torch.equal(g.cpu(), r)


@pytest.mark.parametrize("n_bits", ["384", "all"])
@pytest.mark.parametrize("name", match_cases.CASES)
def test_hamming_argmin_cuda_matches_plain(cuda, name, n_bits):
    """Ties, a train frame with no valid slot, invalid queries keeping their
    argmin, 16 words at 384 and 512 bits, K = 1 and K not a multiple of
    the CTA's 128 queries, B = 1 and 2."""
    words, valid = match_cases.case(name)
    _match_on_card(cuda, words, valid, 384 if n_bits == "384" else words.shape[2] * 32)


@pytest.mark.parametrize("b,k,w,n_bits", [(16, 896, 12, 384), (5, 1520, 12, 384),
                                          (4, 300, 16, 512), (3, 257, 16, 384),
                                          (3, 200, 12, 96), (3, 129, 40, 1024)],
                         ids=["step", "ast", "v1", "v1_384", "3_words", "32_of_40_words"])
def test_hamming_argmin_cuda_at_step_shapes(cuda, b, k, w, n_bits):
    """The step's 896 slots, the AST step's 1,520 (more than one staged
    chunk), v1's 16 words, and the generic body (3 and 32 words)."""
    words, valid = match_cases.step_case(b, k, w, seed=b * k + w)
    _match_on_card(cuda, words, valid, n_bits)


@pytest.mark.parametrize("n_layers", [1, *pyramid_cases.LAYERS, 10])
@pytest.mark.parametrize("shape", pyramid_cases.SHAPES, ids=pyramid_cases.IDS)
def test_pyramid_u8_cuda_matches_plain(cuda, shape, n_layers):
    """Every derived layer bitwise the plain resamplers', one launch a call
    (none for one layer or no output pixel)."""
    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.kernels.downsample import pyramid_u8, pyramid_u8_plain

    frames = torch.from_numpy(pyramid_cases.frames(*shape))
    _kernels.reset_launches()
    got = pyramid_u8(frames.to(cuda), n_layers)
    torch.cuda.synchronize()
    ref = pyramid_u8_plain(frames, n_layers)
    assert len(got) == len(ref) == n_layers
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.is_contiguous() and g.device.type == "cuda"
        assert torch.equal(g.cpu(), r), f"layer {i}"
    any_out = any(r.numel() for r in ref[1:])
    assert _kernels.LAUNCHES["pyramid_u8"] == (1 if any_out else 0)


@pytest.mark.parametrize("view", ["offset", "strided", "one_frame"])
def test_pyramid_u8_cuda_on_views(cuda, view):
    """Frames at an address that is not 16-byte aligned (the byte loads),
    strided frames (copied once) and one (H, W) frame."""
    from ethzasl_brisk_tpu_torch.kernels.downsample import pyramid_u8, pyramid_u8_plain

    base = torch.from_numpy(pyramid_cases.frames(3, 480, 640)).to(cuda)
    frames = {"offset": base.view(-1)[1 : 1 + 2 * 479 * 640].view(2, 479, 640),
              "strided": base[:, 1::2, 3:],
              "one_frame": base[1]}[view]
    got = pyramid_u8(frames, 6)
    ref = pyramid_u8_plain(frames.cpu(), 6)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert torch.equal(g.cpu(), r), f"layer {i}"
