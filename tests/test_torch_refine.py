"""The refine (``detect/refine.py``): the plain version and the kernel's torch
twin bitwise against the JAX ``compact_accepted`` and
``_refine_keypoints_fused``.

Kernel ``refine_keypoints`` runs on the card only (``test_torch_gpu.py``
holds it against the plain version there). Here
``refine_keypoints_plain`` (the torch chain the detector runs on the CPU:
a stable sort a layer for the compaction, nine gathers, ``subpixel2d``)
and ``refine_keypoints_twin`` (the kernel's algorithm: each slot's
candidate by the ranks of the accepted and the rest, its own nine taps,
``subpixel2d``) are held against the JAX package:

* on the Harris layers of seeded 61 x 83 and 96 x 130 frames (noise, a
  flat frame, sharp boxes) with the port's candidate lists and greedy
  uniformity, refine caps of 24: the compacted columns, every KeyPoints
  field and the accepted counts bitwise, x and y against JAX's eager float
  chain (as with ``eager_exact=True``) in float32 and in float64;
* the twin against the plain version (no JAX) on the synthetic maps of
  ``tests/_candidate_cases.py`` (int32 extremes, float scores, ties, and a
  list past two of the kernel's chunks), with no accept, every accept,
  half and accepts only in the last 1,024 flags, caps of k (no
  compaction), k / 2 and 3 (on the long list 64 and one past a chunk's
  slot table), in both refine types;
* the kernel's chunk walk (``chunk_walk``) against the stable partition
  at every row offset in a 16-byte word, with the chunks it ranks and
  skips.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.detect import scale_space as jss  # noqa: E402
from ethzasl_brisk_tpu_torch.detect import refine as rf  # noqa: E402
from ethzasl_brisk_tpu_torch.detect import scale_space as tss  # noqa: E402
from ethzasl_brisk_tpu_torch.kernels import candidates as kc  # noqa: E402
from tests import _candidate_cases as cases  # noqa: E402
from tests.test_torch_masks import frames_of  # noqa: E402

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port on one thread here: tier-1 runs six workers on few cores,
    and the long list's tensors are past torch's grain for threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JAX_CASES = [((61, 83), 2, 0), ((96, 130), 1, 20)]
CANDIDATE_CAP = 150
REFINE_CAP = 24
KP_FIELDS = ("x", "y", "size", "angle", "response", "octave", "valid")
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _detection_tail(shape, octaves, thr):
    """The port's CPU scores, candidate lists and accepts of frames_of(shape)."""
    cfg = tss.DetectorConfig(octaves=octaves, absolute_threshold=float(thr))
    scores, masks = tss.layer_score_masks(
        tss.build_pyramid(torch.from_numpy(frames_of(*shape)), cfg.n_layers), cfg)
    cands, _ = kc.layer_candidates_plain(scores, masks, [CANDIDATE_CAP] * cfg.n_layers)
    return cfg, scores, cands, tss._layer_accepts(cands, cfg)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,octaves,thr", JAX_CASES,
                         ids=[f"{s[0]}x{s[1]}-oct{o}-thr{t}" for s, o, t in JAX_CASES])
def test_refine_matches_jax(shape, octaves, thr, dtype):
    cfg, scores, cands, accepts = _detection_tail(shape, octaves, thr)
    n_layers = cfg.n_layers
    caps = [REFINE_CAP] * n_layers
    geoms = [tss.layer_geometry(i) for i in range(n_layers)]
    rdt = DTYPES[dtype]
    plain, plain_counts = rf.refine_keypoints_plain(scores, cands, accepts, caps, geoms, rdt)
    twin, twin_counts = rf.refine_keypoints_twin(scores, cands, accepts, caps, geoms, rdt)
    jcfg = jss.DetectorConfig(octaves=octaves, absolute_threshold=float(thr),
                              refine_dtype=dtype, refine_capacity=REFINE_CAP)
    with jax.enable_x64(dtype == "float64"):
        for f in range(scores[0].shape[0]):
            comp = [jss.compact_accepted(*(jnp.asarray(t[f].numpy()) for t in c),
                                         jnp.asarray(a[f].numpy()), jcfg, cap=REFINE_CAP)
                    for c, a in zip(cands, accepts)]
            # The compacted columns: the plain compaction's and the twin's slots.
            for i, (c, a) in enumerate(zip(cands, accepts)):
                port = rf.compact_accepted(*(t[f : f + 1] for t in c), a[f : f + 1], REFINE_CAP)
                src = rf.compaction_slots(a[f : f + 1], REFINE_CAP)
                twin_cols = [torch.gather(t[f : f + 1], 1, src) for t in (*c, a)]
                for name, p, t, r in zip(("xs", "ys", "scores", "valid", "accept"),
                                         port, twin_cols, comp[i]):
                    np.testing.assert_array_equal(p[0].numpy(), np.asarray(r), err_msg=name)
                    np.testing.assert_array_equal(t[0].numpy(), np.asarray(r), err_msg=name)
            ref = jss._refine_keypoints_fused([jnp.asarray(sc[f].numpy()) for sc in scores],
                                              comp, geoms, jcfg)
            for name in KP_FIELDS:
                r = _bits(getattr(ref, name))
                np.testing.assert_array_equal(_bits(getattr(plain, name)[f].numpy()), r,
                                              err_msg=f"plain {name}, frame {f}")
                np.testing.assert_array_equal(_bits(getattr(twin, name)[f].numpy()), r,
                                              err_msg=f"twin {name}, frame {f}")
            want = np.array([int(jnp.sum(jnp.asarray(a[f].numpy()))) for a in accepts])
            np.testing.assert_array_equal(plain_counts[f].numpy(), want)
            np.testing.assert_array_equal(twin_counts[f].numpy(), want)
    # The cases decide something: layers cut by the cap and with fewer
    # accepts than slots, sub-pixel moves off the integer grid.
    assert int(plain_counts.max()) > 0 and int(plain_counts.min()) < REFINE_CAP
    assert bool((plain.x != plain.x.round()).any())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("accept_kind", cases.ACCEPT_KINDS)
@pytest.mark.parametrize("kind", cases.REFINE_KINDS)
def test_twin_matches_plain_on_synthetic_maps(kind, accept_kind, dtype):
    scores, masks, caps = cases.case(kind)
    scores = [torch.from_numpy(s) for s in scores]
    cands, _ = kc.layer_candidates_plain(scores, [torch.from_numpy(m) for m in masks], caps)
    accepts = [torch.from_numpy(cases.accepts_for(c[3].numpy(), accept_kind, i))
               for i, c in enumerate(cands)]
    geoms = [tss.layer_geometry(i) for i in range(len(scores))]
    layer_caps = [cases.refine_caps(kind, c[0].shape[1], rf.CHUNK) for c in cands]
    for rcaps in zip(*layer_caps):
        rcaps = list(rcaps)
        plain, pc = rf.refine_keypoints_plain(scores, cands, accepts, rcaps, geoms, DTYPES[dtype])
        twin, tc = rf.refine_keypoints_twin(scores, cands, accepts, rcaps, geoms, DTYPES[dtype])
        assert torch.equal(pc, tc)
        for name in KP_FIELDS:
            p, t = getattr(plain, name), getattr(twin, name)
            if p.dtype == torch.float32:
                p, t = p.view(torch.int32), t.view(torch.int32)
            assert torch.equal(p, t), (name, rcaps)
        assert plain.capacity == sum(rcaps)
        if accept_kind == "none":
            assert not bool(plain.valid.any())
    if kind == "long_list":  # the long rows span three chunks, the second frame's off a word
        assert cands[0][0].shape[1] > 2 * rf.CHUNK
        assert rf.row_offsets(accepts[0]).tolist()[1] == (accepts[0].data_ptr() + 4) % 16


def _stable_partition(accept, cap):
    return torch.sort((~accept).to(torch.uint8), dim=1, stable=True).indices[:, :cap]


@pytest.mark.parametrize("offset", [0, 4, 15])
@pytest.mark.parametrize("accept_kind", cases.ACCEPT_KINDS)
def test_chunk_walk_matches_the_stable_partition(accept_kind, offset):
    """``chunk_walk`` (the kernel's compaction) slot for slot against the
    stable partition on rows of one chunk and of three, at a row offset of
    0, 4 and 15 bytes in a 16-byte word, caps 3, 64, k / 2 and one past a
    chunk's table; where the accepts lie only in the last 1,024 flags and
    the cap is small, the walk ranks the last chunk alone (every slot takes
    an accepted flag) and skips those before it."""
    rng = np.random.default_rng(offset)
    for k in (rf.CHUNK - 16, 2 * rf.CHUNK + 1700):
        valid = rng.random((2, k)) < 0.8
        accept = torch.from_numpy(cases.accepts_for(valid, accept_kind, offset))
        offsets = torch.tensor([offset, (offset + 7) % 16])
        n_chunks = -(-(int(offsets.max()) + k) // rf.CHUNK)
        for cap in (3, 64, k // 2, min(k - 1, rf.CHUNK + 1)):
            src, ranked = rf.chunk_walk(accept, cap, offsets)
            assert torch.equal(src, _stable_partition(accept, cap)), (k, cap)
            assert tuple(ranked.shape) == (2, n_chunks)
            if n_chunks == 1:
                assert bool(ranked.all())
            elif accept_kind == "tail" and cap == 64:
                assert ranked[:, -1].all() and not ranked[:, :-1].any()
            elif accept_kind == "none" and cap <= rf.CHUNK - 16:
                assert ranked[:, 0].all() and not ranked[:, 1:].any()


def test_refine_keypoints_routes_cpu_to_plain_and_cuda_needs_a_card():
    """On CPU tensors ``refine_keypoints`` is the plain version; the
    kernel's wrapper takes CUDA tensors only and refines in float32 or
    float64."""
    _, scores, cands, accepts = _detection_tail((61, 83), 1, 20)
    caps = [REFINE_CAP] * 2
    geoms = [tss.layer_geometry(i) for i in range(2)]
    got, counts = rf.refine_keypoints(scores, cands, accepts, caps, geoms)
    ref, ref_counts = rf.refine_keypoints_plain(scores, cands, accepts, caps, geoms)
    assert torch.equal(counts, ref_counts)
    for g, r in zip(got.fields(), ref.fields()):
        assert torch.equal(g, r)
    with pytest.raises(ValueError, match="CUDA"):
        rf.refine_keypoints_cuda(scores, cands, accepts, caps, geoms)


def test_detect_keypoints_uses_both_dispatchers():
    """``detect_keypoints`` on the CPU equals the plain candidate lists,
    uniformity and refine it is made of, certificate counts included."""
    frames = torch.from_numpy(frames_of(61, 83))
    cfg = tss.DetectorConfig(octaves=2, absolute_threshold=20.0, max_candidates=150,
                             refine_capacity=(24, 16, 8, 8))
    kps, diag = tss.detect_keypoints(frames, cfg, with_diagnostics=True)
    scores, masks = tss.layer_score_masks(tss.build_pyramid(frames, 4), cfg)
    cands, counts = kc.layer_candidates_plain(scores, masks, [150] * 4)
    accepts = tss._layer_accepts(cands, cfg)
    ref, acc = rf.refine_keypoints_plain(scores, cands, accepts, [24, 16, 8, 8],
                                         [tss.layer_geometry(i) for i in range(4)])
    for g, r in zip(kps.fields(), ref.fields()):
        assert torch.equal(g, r)
    assert torch.equal(diag.cand_counts, counts) and torch.equal(diag.accepted_counts, acc)


def test_refine_table_matches_the_kernel_source():
    """The wrapper's tables and the twin's walk agree with the kernel's
    constants: 8 layers a launch, 14 int64 fields a layer, 8 output
    pointers; CTAs of 512 threads, chunks of
    16,384 flags (a run of whole 32-bit words a thread), the first 128
    chunks' counts kept."""
    import pathlib
    import re

    src = (pathlib.Path(rf.__file__).parents[1] / "csrc" / "refine.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kMaxLayers"]) == rf.MAX_LAYERS
    assert int(consts["kFields"]) == rf.FIELDS
    assert int(consts["kOuts"]) == rf.OUTS
    assert int(consts["kThreads"]) == rf.THREADS
    assert int(consts["kChunk"]) == rf.CHUNK == rf.THREADS * rf.RUN
    assert rf.RUN % 32 == 0  # a run of whole words
    assert int(consts["kMaxChunks"]) == rf.MAX_CHUNKS
    doc = src[src.index("// host_layers:"):src.index('extern "C"')]
    assert "scores, xs, ys, top,\n// accept, h, w, k, cap" in doc
    assert "outs: x, y, size,\n// angle, response, octave, valid" in doc
