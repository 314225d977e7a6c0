"""Port parity: the ``exact`` lazy-cache model (``detect/ast_exact.py``)
against the JAX package.

``above_scan_stamps`` in both above modes, ``scatter_stamps``,
``exact_is2d_layer`` (3x3 and float-patch footprints, seeded gates and
prefill), and ``detect_ast_keypoints(raw_cache_model="exact")`` on a
96 x 128 crop at octaves 2, at a cap that covers every corner and at one
small enough that ``AstDiagnostics.ok`` is False (the truncated candidate
lists too), and at octaves 0 (the single-layer branch) with every model.
The JAX functions run op by op under ``jax.enable_x64(True)``. Tolerance:
bit for bit on every field of every slot.
"""
import numpy as np
import pytest
import torch
from scipy import ndimage

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.detect import ast_exact as jex  # noqa: E402
from ethzasl_brisk_tpu.detect import ast_scale_space as jas  # noqa: E402
from ethzasl_brisk_tpu_torch.detect import ast_exact as tex  # noqa: E402
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
CAP = 2048


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
        got, ref = got.view(np.int32), ref.view(np.int32)
    np.testing.assert_array_equal(got, ref, err_msg=what)


def _same_kps(got, ref):
    for f in FIELDS:
        _same(getattr(got, f)[0], getattr(ref, f), f)


@pytest.fixture(scope="module")
def img():
    return crop(96, 128, seed=5)


@pytest.fixture(scope="module")
def layers(img):
    with jax.enable_x64(True):
        jl = jas.build_ast_pyramid(jnp.asarray(img), 2, 40)
    return jl, tas.build_ast_pyramid(torch.from_numpy(img)[None], 2, 40)


def _cands(tl, i):
    xs, ys, valid = tas.layer_candidates(tl[i].corner, CAP)
    return (xs, ys, valid), tuple(jnp.asarray(a[0].numpy()) for a in (xs, ys, valid))


@pytest.mark.parametrize("mode,i", [("above_octave", 0), ("above_intra", 1),
                                    ("above_octave", 2)])
def test_above_scan_stamps_and_scatter_bitwise(layers, mode, i):
    jl, tl = layers
    (xs, ys, valid), (jxs, jys, jvalid) = _cands(tl, i)
    center = tas._gather(tl[i].cache, ys, xs)
    jcenter = jnp.asarray(center[0].numpy())
    with jax.enable_x64(True):
        ref = jex.above_scan_stamps(jl[i + 1], jxs, jys, jcenter, mode)
    got = tex.above_scan_stamps(tl[i + 1], xs, ys, center, mode)
    for g, r, name in zip(got, ref, ("ax", "ay", "stamp")):
        _same(g[0], r, f"{mode} {name}")
    active = np.random.default_rng(i).random(CAP) < 0.7
    ref_map = jex.scatter_stamps(jl[i + 1], *ref, jvalid & jnp.asarray(active))
    got_map = tex.scatter_stamps(tl[i + 1], *got, valid & torch.from_numpy(active)[None])
    _same(got_map[0], ref_map, "scatter_stamps")
    assert bool(got_map.any())


@pytest.mark.parametrize("float_patch", [False, True])
@pytest.mark.parametrize("i", [0, 3])
def test_exact_is2d_layer_bitwise(layers, i, float_patch):
    """The sequential loop with seeded 3-D gates and a seeded prefill."""
    jl, tl = layers
    (xs, ys, valid), (jxs, jys, jvalid) = _cands(tl, i)
    rng = np.random.default_rng(10 * i + float_patch)
    gate = rng.random(CAP) < 0.6
    prefill = rng.random(tl[i].shape) < 0.3
    ref = jex.exact_is2d_layer(jl[i], jxs, jys, jvalid, jnp.asarray(gate), jnp.asarray(prefill),
                               float_patch=float_patch)
    got = tex.exact_is2d_layer(tl[i], xs, ys, valid, torch.from_numpy(gate)[None],
                               torch.from_numpy(prefill)[None], float_patch=float_patch)
    _same(got[0], ref)
    assert 0 < int(got.sum()) <= int(valid.sum())


def test_exact_is2d_layer_batch(layers, img):
    """Frames of a batch run their loops side by side, each as alone."""
    tl = layers[1]
    imgs = torch.from_numpy(np.stack([img, img[:, ::-1].copy()]))
    tb = tas.build_ast_pyramid(imgs, 2, 40)
    xs, ys, valid = tas.layer_candidates(tb[0].corner, CAP)
    gate = torch.ones_like(valid)
    pre = torch.zeros_like(tb[0].corner)
    both = tex.exact_is2d_layer(tb[0], xs, ys, valid, gate, pre)
    alone = tex.exact_is2d_layer(tl[0], xs[:1], ys[:1], valid[:1], gate[:1], pre[:1])
    assert torch.equal(both[:1], alone)


@pytest.fixture(scope="module")
def exact_ref(img):
    with jax.enable_x64(True):
        return {cap: jas.detect_ast_keypoints(
            jnp.asarray(img), threshold=40, octaves=2, max_candidates_per_layer=cap,
            raw_cache_model="exact", with_diagnostics=True) for cap in (CAP, 256)}


@pytest.mark.parametrize("cap", [CAP, 256])
def test_detect_exact_bitwise(img, exact_ref, cap):
    kps, diag = tas.detect_ast_keypoints(torch.from_numpy(img)[None], threshold=40, octaves=2,
                                         max_candidates_per_layer=cap, raw_cache_model="exact",
                                         with_diagnostics=True)
    ref, rdiag = exact_ref[cap]
    _same_kps(kps, ref)
    _same(diag.ok[0], rdiag.ok, "ok")
    # Under x64 the JAX sums are int64; the port keeps the default int32.
    _same(diag.corner_counts[0], np.asarray(rdiag.corner_counts).astype(np.int32), "counts")
    _same(diag.cand_caps, rdiag.cand_caps, "caps")
    assert bool(diag.ok[0]) == (cap == CAP)


def test_exact_differs_from_emulated(img, exact_ref):
    """The models disagree somewhere on this crop, so the exact loop is
    really exercised (both held to JAX elsewhere)."""
    emu = tas.detect_ast_keypoints(torch.from_numpy(img)[None], threshold=40, octaves=2,
                                   max_candidates_per_layer=CAP)
    assert not np.array_equal(emu.valid[0].numpy(), np.asarray(exact_ref[CAP][0].valid))


@pytest.mark.parametrize("model", ["exact", "emulated", "cache", "corner", "unsuppressed"])
def test_detect_single_layer_bitwise(img, model):
    """octaves=0: one layer, the float-patch footprint, octave 0, size 12."""
    kw = dict(threshold=40, octaves=0, max_candidates_per_layer=CAP)
    if model == "unsuppressed":
        kw["suppress_scale_nonmaxima"] = False
    else:
        kw["raw_cache_model"] = model
    with jax.enable_x64(True):
        ref = jas.detect_ast_keypoints(jnp.asarray(img), **kw)
    got = tas.detect_ast_keypoints(torch.from_numpy(img)[None], **kw)
    _same_kps(got, ref)
    assert int(got.valid.sum()) > 100
