"""Port parity: the AST scale space's numerics, scans and detection against the
JAX package.

Unit functions on seeded random int patches and ties (``ast_subpixel2d``,
the three ``refine1d``s, ``_bilinear_score``), ``is_max_2d`` under each raw
model and ``_score_patch_max`` in each of its four modes on the layers of a
240 x 320 crop, and ``detect_ast_keypoints`` on that crop at octaves 3 (six
layers: all four scan modes, layer 0's AGAST 5/8 below, the intra last
layer) with the ``emulated``, ``cache`` and ``corner`` models, suppressed
and not, and ``with_diagnostics``. Every candidate list here has the one
capacity ``CAP`` (invalid slots at (0, 0) included): the JAX functions
compile per shape, and one shape keeps the file's time down.

The JAX functions run op by op, as they run when called directly, under
``jax.enable_x64(True)``: the reference's double sites are then double, as
in the port. Tolerance: bit for bit on every field of every slot.
"""
import numpy as np
import pytest
import torch
from scipy import ndimage

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.detect import ast_scale_space as jas  # noqa: E402
from ethzasl_brisk_tpu_torch.detect import ast_scale_space as tas  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port on one thread here: tier-1 runs six workers on few cores,
    and the JAX reference's compiles take the rest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIELDS = ("x", "y", "size", "angle", "response", "octave", "valid")
CAP = 4096
MODES = {"above_octave": (0, 1), "above_intra": (1, 2), "below_octave": (2, 1),
         "below_intra": (3, 2)}  # mode: (candidate layer, neighbour layer)


def crop(h, w, seed):
    """A smoothed-noise uint8 crop (tests/test_ast_parity.py:215-230)."""
    base = np.random.default_rng(seed).integers(0, 256, (h, w)).astype(np.float32)
    return np.clip(ndimage.convolve(base, np.ones((3, 3)) / 9.0, mode="nearest"),
                   0, 255).astype(np.uint8)


def _same(got: torch.Tensor, ref, what=""):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape, (what, got.dtype, ref.dtype)
    if got.dtype.kind == "f":
        got, ref = got.view(np.int32 if got.itemsize == 4 else np.int64), ref.view(
            np.int32 if ref.itemsize == 4 else np.int64)
    np.testing.assert_array_equal(got, ref, err_msg=what)


def _same_kps(got, ref, batch_index=0):
    for f in FIELDS:
        _same(getattr(got, f)[batch_index], getattr(ref, f), f)


@pytest.fixture(scope="module")
def img():
    return crop(240, 320, seed=5)


@pytest.fixture(scope="module")
def layers(img):
    with jax.enable_x64(True):
        jl = jas.build_ast_pyramid(jnp.asarray(img), 3, 40)
    return jl, tas.build_ast_pyramid(torch.from_numpy(img)[None], 3, 40)


def _cands(tl, i):
    xs, ys, valid = tas.layer_candidates(tl[i].corner, CAP)
    return (xs, ys, valid), tuple(jnp.asarray(a[0].numpy()) for a in (xs, ys, valid))


def _patches(n, seed):
    """Seeded int score patches: random, sparse, constant, and with ties."""
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 256, (n, 3, 3))
    p[: n // 4] *= rng.random((n // 4, 3, 3)) < 0.3           # sparse
    m = min(50, n // 4)
    p[n // 4 : n // 4 + m] = rng.integers(0, 255, (m, 1, 1))  # constant
    small = rng.integers(0, 4, (n // 4, 3, 3))                 # many ties
    p[-(n // 4):] = small
    p[-1] = [[1, 0, 1], [0, 0, 0], [1, 0, 1]]                  # all four corners tie
    return p.astype(np.int32)


def test_argmax_keeps_the_first_maximum():
    """ast_subpixel2d's corner branch needs the first maximum on ties."""
    v = torch.tensor([[3, 7, 7, 1], [2, 2, 2, 2], [0, 1, 5, 5]])
    assert torch.argmax(v, dim=-1).tolist() == [1, 0, 2]


def test_ast_subpixel2d_bitwise():
    p = _patches(4000, 1)
    with jax.enable_x64(True):
        ref = jas.ast_subpixel2d(jnp.asarray(p))
    got = tas.ast_subpixel2d(torch.from_numpy(p))
    for g, r, name in zip(got, ref, ("dx", "dy", "val")):
        _same(g, r, name)
    # The all-corners-tie patch takes the first corner (+1, +1).
    assert (float(got[0][-1]), float(got[1][-1])) in ((1.0, 1.0), (0.0, 0.0))


def test_ast_subpixel2d_batched_shape():
    p = _patches(60, 2).reshape(3, 20, 3, 3)
    got = tas.ast_subpixel2d(torch.from_numpy(p))
    flat = tas.ast_subpixel2d(torch.from_numpy(p.reshape(60, 3, 3)))
    for g, f in zip(got, flat):
        assert g.shape == (3, 20) and torch.equal(g.reshape(-1), f)


@pytest.mark.parametrize("name", ["refine1d", "refine1d_1", "refine1d_2"])
def test_refine1d_bitwise(name):
    rng = np.random.default_rng(len(name))
    n = 5000
    s = rng.integers(0, 256, (3, n)).astype(np.float32)
    s[:, : n // 2] += rng.random((3, n // 2)).astype(np.float32) * 3  # refined maxima
    s[1, n // 2 : n // 2 + 500] = s[0, n // 2 : n // 2 + 500]            # ties
    s[2, n // 2 + 500 : n // 2 + 900] = s[1, n // 2 + 500 : n // 2 + 900]
    s[:, -300:] = rng.integers(0, 3, (3, 300))                          # flat
    with jax.enable_x64(True):
        ref = getattr(jas, name)(*(jnp.asarray(a) for a in s))
    got = getattr(tas, name)(*(torch.from_numpy(a) for a in s))
    _same(got[0], ref[0], "scale")
    _same(got[1], ref[1], "max")


def test_int_score_bitwise(layers):
    """GetAgastScore at a threshold, in and out of the frame."""
    jl, tl = layers
    rng = np.random.default_rng(6)
    h, w = tl[0].shape
    xs = rng.integers(-3, w + 3, 3000).astype(np.int32)
    ys = rng.integers(-3, h + 3, 3000).astype(np.int32)
    center = rng.integers(0, 80, 3000).astype(np.int32)
    ref = jas._int_score(jl[0], jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(center))
    got = tas._int_score(tl[0], *(torch.from_numpy(a)[None] for a in (xs, ys, center)))
    _same(got[0], ref)


def test_bilinear_score_bitwise(layers):
    jl, tl = layers
    rng = np.random.default_rng(4)
    h, w = tl[1].shape
    xf = rng.uniform(-2, w + 1, 3000).astype(np.float32)
    yf = rng.uniform(-2, h + 1, 3000).astype(np.float32)
    ref = jas._bilinear_score(jl[1], jnp.asarray(xf), jnp.asarray(yf))
    got = tas._bilinear_score(tl[1], torch.from_numpy(xf)[None], torch.from_numpy(yf)[None])
    _same(got[0], ref)


@pytest.mark.parametrize("raw_model", ["emulated", "cache", "corner"])
@pytest.mark.parametrize("layer", [0, 3])
def test_is_max_2d_bitwise(layers, raw_model, layer):
    """IsMax2D of every corner of a layer; ``emulated`` also with seeded
    e_patch and prefill maps."""
    jl, tl = layers
    (xs, ys, _), (jxs, jys, _) = _cands(tl, layer)
    ref = jas.is_max_2d(jl[layer], jxs, jys, raw_model=raw_model)
    got = tas.is_max_2d(tl[layer], xs, ys, raw_model=raw_model)
    _same(got[0], ref, raw_model)
    if raw_model == "emulated":
        rng = np.random.default_rng(layer)
        shape = tl[layer].shape
        e_patch = rng.integers(0, shape[0] * shape[1], shape).astype(np.int32)
        prefill = rng.random(shape) < 0.2
        ref = jas.is_max_2d(jl[layer], jxs, jys, raw_model=raw_model,
                            e_patch=jnp.asarray(e_patch), prefill=jnp.asarray(prefill))
        got2 = tas.is_max_2d(tl[layer], xs, ys, raw_model=raw_model,
                             e_patch=torch.from_numpy(e_patch)[None],
                             prefill=torch.from_numpy(prefill)[None])
        _same(got2[0], ref, "emulated with e_patch and prefill")
        assert not torch.equal(got2, got)


def test_is_max_2d_rejects_unknown_model(layers):
    (xs, ys, _), _ = _cands(layers[1], 0)
    with pytest.raises(ValueError, match="raw_model"):
        tas.is_max_2d(layers[1][0], xs, ys, raw_model="fresh")


@pytest.mark.parametrize("mode", list(MODES))
def test_score_patch_max_bitwise(layers, mode):
    """Each scan mode over every corner of its layer, thresholds at the
    candidates' own scores and at 0 (no early drop) as well."""
    jl, tl = layers
    i, n = MODES[mode]
    (xs, ys, _), (jxs, jys, _) = _cands(tl, i)
    tcenter = tas._cache_score(tl[i], xs, ys)
    jcenter = jnp.asarray(tcenter[0].numpy())
    ismax = []
    for thr_t, thr_j in ((tcenter, jcenter), (tcenter * 0, jcenter * 0)):
        with jax.enable_x64(True):
            ref = jas._score_patch_max(jl[n], jxs, jys, thr_j, mode)
        got = tas._score_patch_max(tl[n], xs, ys, thr_t, mode)
        for g, r, name in zip(got, ref, ("ismax", "score", "dx", "dy")):
            _same(g[0], r, f"{mode} {name}")
        ismax.append(int(got[0].sum()))
    assert 0 < ismax[0] < xs.numel() and ismax[1] < ismax[0]


@pytest.fixture(scope="module")
def detect_ref(img):
    """The JAX runs of this crop, one per mode."""
    out = {}
    with jax.enable_x64(True):
        for model in ("emulated", "cache", "corner"):
            out[model] = jas.detect_ast_keypoints(
                jnp.asarray(img), threshold=40, octaves=3, max_candidates_per_layer=CAP,
                raw_cache_model=model, with_diagnostics=True)
        out["unsuppressed"] = jas.detect_ast_keypoints(
            jnp.asarray(img), threshold=40, octaves=3, max_candidates_per_layer=CAP,
            suppress_scale_nonmaxima=False)
    return out


@pytest.mark.parametrize("model", ["emulated", "cache", "corner"])
def test_detect_ast_keypoints_bitwise(img, detect_ref, model):
    kps, diag = tas.detect_ast_keypoints(
        torch.from_numpy(img)[None], threshold=40, octaves=3, max_candidates_per_layer=CAP,
        raw_cache_model=model, with_diagnostics=True)
    ref, rdiag = detect_ref[model]
    _same_kps(kps, ref)
    _same(diag.ok[0], rdiag.ok, "ok")
    # Under x64 the JAX sums are int64; the port keeps the int32 of the
    # JAX package's default.
    _same(diag.corner_counts[0], np.asarray(rdiag.corner_counts).astype(np.int32), "counts")
    _same(diag.cand_caps, rdiag.cand_caps, "caps")
    assert bool(diag.ok[0])
    octaves = kps.octave[0][kps.valid[0]]
    assert set(octaves.tolist()) >= {0, 1, 2, 3, 4}


def test_detect_unsuppressed_bitwise(img, detect_ref):
    kps = tas.detect_ast_keypoints(torch.from_numpy(img)[None], threshold=40, octaves=3,
                                   max_candidates_per_layer=CAP, suppress_scale_nonmaxima=False)
    _same_kps(kps, detect_ref["unsuppressed"])


def test_detect_per_layer_caps_equal_uniform_cap(img, layers, detect_ref):
    """Per-layer caps that cover every corner give the uniform cap's
    keypoints: the valid slots in order, bit for bit."""
    caps = tuple(int(la.corner.sum()) + 16 for la in layers[1])
    kps = tas.detect_ast_keypoints(torch.from_numpy(img)[None], threshold=40, octaves=3,
                                   max_candidates_per_layer=caps)
    assert kps.capacity == sum(caps)
    ref = detect_ref["emulated"][0]
    v = np.asarray(ref.valid)
    assert int(kps.valid.sum()) == int(v.sum())
    for f in FIELDS:
        got = getattr(kps, f)[0][kps.valid[0]].numpy()
        np.testing.assert_array_equal(got, np.asarray(getattr(ref, f))[v], err_msg=f)


def test_detect_batch_is_per_frame(img, detect_ref):
    """Frames of a batch are independent: the crop beside a flipped copy."""
    batch = torch.from_numpy(np.stack([img[::-1, ::-1].copy(), img]))
    kps = tas.detect_ast_keypoints(batch, threshold=40, octaves=3, max_candidates_per_layer=CAP,
                                   raw_cache_model="cache")
    _same_kps(kps, detect_ref["cache"][0], batch_index=1)
