"""The candidate lists (``kernels/candidates.py``): the plain version and the
kernel's torch twin bitwise against the JAX ``_layer_candidates``.

Kernel ``layer_candidates`` runs on the card only (``test_torch_gpu.py``
holds it against the plain version there, on both of its routes). Here
``layer_candidates_plain`` (the stable full-map sort the detector runs on
the CPU) and ``layer_candidates_twin`` (the kernel's algorithm: the map
cut into a cluster's slices, the survivors listed in flat order, all of
them or, past the cap, after a radix select of the k-th word with the
first ties in flat order; four stable 8-bit LSD passes on the words, a
pass skipped where one digit holds every key; then the pixels that do not
survive, in flat order) are held slot for slot against the JAX package's
``lax.top_k`` lists:

* on the Harris layers of seeded 61 x 83 and 96 x 130 frames (noise, a
  flat frame, sharp boxes; octaves 0-2, thresholds 0 and 20) at caps
  below, around and above what survives, the whole map included;
* on synthetic maps no Harris frame gives (``tests/_candidate_cases.py``):
  no mask bit, every pixel at the sentinel, survivors past the cap, ties,
  masked-in INT32_MIN, float +0.0 / -0.0 / -inf (``lax.top_k`` orders
  floats by their total order: +0.0 above -0.0), masked-in NaNs with the
  sign set (under -inf in that order), wide float spreads, and long tie
  runs that the cap cuts (a flat map, boxes, runs of rows).

The JAX function runs eagerly on the port's score maps and masks (which
``test_torch_masks.py`` holds against JAX's), a frame at a time.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.detect import scale_space as jss  # noqa: E402
from ethzasl_brisk_tpu_torch.detect import scale_space as tss  # noqa: E402
from ethzasl_brisk_tpu_torch.kernels import candidates as kc  # noqa: E402
from tests import _candidate_cases as cases  # noqa: E402
from tests.test_torch_masks import frames_of  # noqa: E402

JAX_CASES = [((61, 83), 0, 20), ((61, 83), 2, 0), ((96, 130), 1, 0), ((96, 130), 2, 20)]
FIELDS = ("xs", "ys", "scores", "valid")


def _bits(t):
    """An array whose equality is bit equality (float scores as int32)."""
    a = np.asarray(t)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_lists_equal(got, ref, what):
    for name, g, r in zip(FIELDS, got, ref):
        np.testing.assert_array_equal(_bits(g), _bits(r), err_msg=f"{what}: {name}")


def _jax_lists(scores, masks, caps):
    """The JAX lists a layer and frame: [layer][frame] -> (xs, ys, scores, valid)."""
    cfg = jss.DetectorConfig()
    return [[jss._layer_candidates(jnp.asarray(sc[f].numpy()), jnp.asarray(m[f].numpy()), cfg,
                                   cap)[:4]
             for f in range(sc.shape[0])]
            for sc, m, cap in zip(scores, masks, caps)]


def _check_against_jax(scores, masks, caps, what):
    plain, plain_counts = kc.layer_candidates_plain(scores, masks, caps)
    twin, twin_counts = kc.layer_candidates_twin(scores, masks, caps)
    ref = _jax_lists(scores, masks, caps)
    for i in range(len(scores)):
        for f in range(scores[i].shape[0]):
            where = f"{what}, layer {i}, frame {f}"
            _assert_lists_equal([c[f].numpy() for c in plain[i]], ref[i][f], f"plain {where}")
            _assert_lists_equal([c[f].numpy() for c in twin[i]], ref[i][f], f"twin {where}")
    want = np.stack([np.asarray(jnp.sum(jnp.asarray(m.numpy()).astype(jnp.int32), axis=(1, 2)))
                     for m in masks], axis=1)
    np.testing.assert_array_equal(plain_counts.numpy(), want)
    np.testing.assert_array_equal(twin_counts.numpy(), want)
    return plain


@pytest.mark.parametrize("shape,octaves,thr", JAX_CASES,
                         ids=[f"{s[0]}x{s[1]}-oct{o}-thr{t}" for s, o, t in JAX_CASES])
def test_candidates_match_jax(shape, octaves, thr):
    """Every layer's list and counts on the Harris layers, caps 7 (the
    twin's radix select), 150 and the whole map."""
    frames = frames_of(*shape)
    cfg = tss.DetectorConfig(octaves=octaves, absolute_threshold=float(thr))
    scores, masks = tss.layer_score_masks(tss.build_pyramid(torch.from_numpy(frames),
                                                            cfg.n_layers), cfg)
    for caps in ([7] * cfg.n_layers, [150] * cfg.n_layers, [sc[0].numel() for sc in scores]):
        plain = _check_against_jax(scores, masks, caps, f"caps {caps}")
    # The cases decide something: the noise frame's layer 0 holds more
    # candidates than 7, and the whole-map lists end in sentinel fills.
    assert int(masks[0][0].sum()) > 7
    assert not bool(plain[0][3][:, -1].all())


@pytest.mark.parametrize("kind", cases.KINDS)
def test_candidates_match_jax_on_synthetic_maps(kind):
    """The synthetic maps of ``tests/_candidate_cases.py``, slot for slot."""
    scores, masks, caps = cases.case(kind)
    plain = _check_against_jax([torch.from_numpy(s) for s in scores],
                               [torch.from_numpy(m) for m in masks], caps, kind)
    if kind == "all_masked_out":
        assert not any(bool(c[3].any()) for c in plain)
    if kind == "no_survivor":
        assert all(bool(c[3].all()) for c in plain)


def test_signed_zero_order_is_jax_total_order():
    """Masked-in +0.0 ranks above -0.0 (``lax.top_k``'s total order), where
    a sort of the values would tie them and keep the lower index first."""
    sc = torch.tensor([[[-0.0, 0.0, -0.0, 0.0, 1.0, float("-inf")]]])
    mask = torch.tensor([[[True, True, True, True, True, False]]])
    for fn in (kc.layer_candidates_plain, kc.layer_candidates_twin):
        (xs, _, top, valid), = fn([sc], [mask], [6])[0]
        assert xs[0].tolist() == [4, 1, 3, 0, 2, 5]
        assert torch.signbit(top[0]).tolist() == [False, False, False, True, True, True]
        assert valid[0].tolist() == [True] * 5 + [False]


def test_signed_nan_orders_under_the_sentinel():
    """A masked-in NaN with its sign set ranks under -inf (``lax.top_k``'s
    total order): after every pixel at the sentinel, masked in or out, by
    its bits, keeping them; a NaN without its sign ranks first."""
    bits = np.array([0xFFC00000, 0xFF800001, 0xFFFFFFFF, 0xFF800000, 0x3F800000, 0,
                     0x80000000, 0x7FC00000, 0xFF800001, 0x40000000], np.uint32)
    sc = torch.from_numpy(bits.view(np.float32).reshape(1, 1, 10))
    mask = torch.tensor([[[True] * 9 + [False]]])
    ref = jax.lax.top_k(jnp.where(jnp.asarray(mask.numpy()), jnp.asarray(sc.numpy()), -jnp.inf)
                        .reshape(-1), 10)
    for fn in (kc.layer_candidates_plain, kc.layer_candidates_twin):
        (xs, _, top, valid), = fn([sc], [mask], [10])[0]
        assert xs[0].tolist() == [7, 4, 5, 6, 3, 9, 1, 8, 0, 2]
        assert xs[0].tolist() == np.asarray(ref[1]).tolist()
        np.testing.assert_array_equal(top[0].numpy().view(np.uint32),
                                      np.asarray(ref[0]).view(np.uint32))
        assert valid[0].tolist() == [True] * 5 + [False] + [True] * 4


def test_twin_matches_plain_on_bench_layers():
    """The twin against the plain version on two bench-size layers' worth
    of frames at the main path's caps (no JAX): 9,000-odd survivors under
    10240 on layer 0, the fill after them."""
    from ethzasl_brisk_tpu_torch.frames import bench_frames

    cfg = tss.DetectorConfig(octaves=1, absolute_threshold=20.0)
    scores, masks = tss.layer_score_masks(
        tss.build_pyramid(torch.from_numpy(bench_frames(1)), cfg.n_layers), cfg)
    caps = [10240, 3072]
    plain, pc = kc.layer_candidates_plain(scores, masks, caps)
    twin, tc = kc.layer_candidates_twin(scores, masks, caps)
    assert torch.equal(pc, tc)
    for p, t in zip(plain, twin):
        for a, b in zip(p, t):
            assert torch.equal(a, b)
    assert int(pc[0, 0]) < caps[0] and bool(plain[0][3][0, : int(pc[0, 0])].all())


def test_layer_candidates_routes_cpu_to_plain_and_cuda_needs_a_card():
    """On CPU tensors ``layer_candidates`` is the plain version; the kernel's
    wrapper takes CUDA tensors only."""
    scores, masks, caps = cases.case("ties")
    scores = [torch.from_numpy(s) for s in scores]
    masks = [torch.from_numpy(m) for m in masks]
    got, counts = kc.layer_candidates(scores, masks, caps)
    ref, ref_counts = kc.layer_candidates_plain(scores, masks, caps)
    assert torch.equal(counts, ref_counts)
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        kc.layer_candidates_cuda(scores, masks, caps)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_twin_matches_plain_at_every_cluster(cluster):
    """The twin at each cluster size the plan can pick against the plain
    version on every synthetic case (no JAX): the slices, the listing
    offsets, the select's tie split over the slices and the stable passes
    change with the cluster, the lists must not."""
    for kind in cases.KINDS:
        scores, masks, caps = cases.case(kind)
        scores = [torch.from_numpy(s) for s in scores]
        masks = [torch.from_numpy(m) for m in masks]
        ref, ref_counts = kc.layer_candidates_plain(scores, masks, caps)
        got, counts = kc.layer_candidates_twin(scores, masks, caps, cluster=cluster)
        assert torch.equal(counts, ref_counts), kind
        for i, (g, r) in enumerate(zip(got, ref)):
            for name, a, b in zip(FIELDS, g, r):
                assert np.array_equal(_bits(a.numpy()), _bits(b.numpy())), (kind, i, name)


def test_twin_skips_the_passes_one_digit_holds():
    """Pass skipping as the kernel does it: the flat map's one word skips
    every pass; on a bench frame's int32 Harris layers (its survivors'
    scores all between the threshold and 2^16) the two top digits are one
    bin each and their passes are skipped, the two low digits' passes
    run."""
    from ethzasl_brisk_tpu_torch.frames import bench_frames

    scores, masks, caps = cases.case("tie_runs")
    passes = []
    kc.layer_candidates_twin([torch.from_numpy(s) for s in scores],
                             [torch.from_numpy(m) for m in masks], caps, passes=passes)
    assert passes[0].tolist() == [0xF0, 0xF0]
    cfg = tss.DetectorConfig(octaves=1, absolute_threshold=20.0)
    scores, masks = tss.layer_score_masks(
        tss.build_pyramid(torch.from_numpy(bench_frames(1)), cfg.n_layers), cfg)
    passes = []
    kc.layer_candidates_twin(scores, masks, [10240, 3072], passes=passes)
    assert all(p.tolist() == [0xC3] for p in passes), passes


def test_slices_cover_the_map_once():
    """The kernel's slices of a plane, at every alignment of its mask and
    every cluster size: contiguous, in order, covering every pixel once,
    cut at group boundaries (16-byte loads inside), some empty on a map
    smaller than the cluster's groups."""
    for n in (1, 5, 20, 83 * 61, 640 * 480):
        for offset in range(16):
            for cluster in kc.CLUSTERS:
                sl = kc._slices(n, offset, cluster)
                assert sl[0][0] == 0 and sl[-1][1] == n
                assert all(a[1] == b[0] for a, b in zip(sl, sl[1:]))
                head = min((16 - offset) % 16, n)
                tail = head + (n - head) // 16 * 16
                assert all(a <= head or a >= tail or (a - head) % 16 == 0 for a, _ in sl)
    assert any(a == b for a, b in kc._slices(5, 0, 16))


@pytest.mark.parametrize("frames,layers,largest,k,cluster,route", [
    (16, 4, 480 * 640, 10240, 4, "shared"),    # the B=16 step, layer 0
    (128, 4, 480 * 640, 10240, 1, "device"),   # the B=128 step, layer 0
    (128, 4, 480 * 640, 3072, 1, "shared"),    # ... and layers 1-2
    (32, 4, 480 * 640, 10240, 2, "shared"),
    (1, 1, 480 * 640, 18432, 16, "shared"),    # the quick start's certified cap
    (1, 1, 480 * 640, 480 * 640, 16, "device"),  # a whole VGA map
    (1, 4, 480 * 640, 10240, 8, "shared"),     # a B=1 detection (VO, camera grids)
    (3, 4, 61 * 83, 5063, 8, "shared"),
    (4, 4, 480 * 640, 10240, 8, "shared"),     # [gpu vs cpu]
])
def test_route_plan(frames, layers, largest, k, cluster, route):
    """The plan: clusters of 8 while the launch's CTAs stay within 256
    (about one wave of two CTAs an SM), halved past it, 16 for one or two
    VGA-size lists; a layer's keys in
    the cluster's shared memory while a CTA's share ceil(k / C) fits
    PART_KEYS (the main path's caps at B=16, the quick start's),
    else in device memory; a CTA's shared bytes (a share of the list and
    half as much again to stage its slice's survivors) within two CTAs an
    SM at the largest share."""
    assert kc.cluster_size(frames, layers, largest) == cluster
    assert kc.layer_route(k, cluster) == route
    assert 2 * (kc.shared_bytes([kc.PART_KEYS * cluster], cluster) + 1024) <= 233472


def test_candidates_table_matches_the_kernel_source():
    """The wrapper's layer table and plan agree with the kernel's
    constants: 8 layers a launch, 11 int64 fields a layer, 512 threads, up
    to 5,632 keys in each of a CTA's two shared buffers behind 18 KB of
    tables, clusters of up to 16 CTAs."""
    import pathlib
    import re

    src = (pathlib.Path(kc.__file__).parents[1] / "csrc" / "candidates.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kMaxLayers"]) == kc.MAX_LAYERS
    assert int(consts["kFields"]) == kc.FIELDS
    assert int(consts["kThreads"]) == kc.THREADS
    assert int(consts["kPartKeys"]) == kc.PART_KEYS
    assert int(consts["kBufferKeys"]) == kc.BUFFER_KEYS
    assert int(consts["kSharedBytes"]) == kc.SHARED_BYTES
    assert int(consts["kMaxCluster"]) == kc.MAX_CLUSTER == max(kc.CLUSTERS)
    # The table's fields, in the entry's order.
    doc = src[src.index("// host_layers:"):src.index('extern "C"')]
    assert "scores, mask, xs, ys,\n// top, valid, scratch" in doc
