"""Port parity: the v1 engine's detection (``detect_ast_keypoints(...,
v1=True)``, ``BriskFeatureDetector(version="v1")``) against the JAX
package, ``emulated`` cache model.

The v1 engine (brisk-v1.cc:577-1110): its own resamplers, plain OAST
corners at a constant threshold (no threshold map), no scale-axis
weak/edge gates in Refine3D, drop threshold 0 in the neighbour-layer
scans. A 96 x 128 smoothed-noise crop at octaves 2, threshold 40, one cap
for every layer (fewer shapes for the JAX reference to compile), so every
branch of Refine3D runs (layer 0, intra layer 1, octave layer 2, the last
layer). The JAX functions run op by op under ``jax.enable_x64(True)``
(the reference's double sites in double, as the port computes them); the
pyramid's dense maps come along. Tolerance: bit for bit on every field of
every slot. The ``exact`` model and the non-suppressed mode are in
``test_torch_v1_exact.py``, the float32 mode in ``test_torch_v1_f32.py``
and the dense engine in ``test_torch_v1_dense.py`` (one file each: the
JAX reference compiles op by op, ~30-50 s a model).
"""
import numpy as np
import pytest
import torch
from scipy import ndimage

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.detect import ast_scale_space as jas  # noqa: E402
from ethzasl_brisk_tpu_torch import BriskFeatureDetector  # noqa: E402
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
KW = dict(threshold=40, octaves=2, max_candidates_per_layer=512)


def _same(got: torch.Tensor, ref, what=""):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape, (what, got.dtype, ref.dtype)
    if got.dtype.kind == "f":
        got, ref = got.view(np.int32), ref.view(np.int32)
    np.testing.assert_array_equal(got, ref, err_msg=what)


@pytest.fixture(scope="module")
def img():
    base = np.random.default_rng(21).integers(0, 256, (96, 128)).astype(np.float32)
    return np.clip(ndimage.convolve(base, np.ones((3, 3)) / 9.0, mode="nearest"),
                   0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def ref(img):
    """The JAX v1 detection, op by op under x64, with its diagnostics."""
    with jax.enable_x64(True):
        return jas.detect_ast_keypoints(jnp.asarray(img), **KW, v1=True, with_diagnostics=True)


def test_v1_pyramid_bitwise(img, ref):
    with jax.enable_x64(True):
        ref = jas.build_ast_pyramid(jnp.asarray(img), 2, KW["threshold"], v1=True)
    got = tas.build_ast_pyramid(torch.from_numpy(img)[None], 2, KW["threshold"], v1=True)
    assert len(got) == len(ref) == 4
    for i, (g, r) in enumerate(zip(got, ref)):
        for f in ("img", "t_star", "thrmap", "corner", "cache"):
            _same(getattr(g, f)[0], getattr(r, f), f"layer {i} {f}")
        assert (g.scale, g.offset) == (r.scale, r.offset)
    v2 = tas.build_ast_pyramid(torch.from_numpy(img)[None], 2, KW["threshold"])
    assert not torch.equal(got[1].img, v2[1].img), "the v1 resamplers"
    assert not torch.equal(got[0].corner, v2[0].corner), "no threshold map"


def test_v1_suppressed_bitwise(img, ref):
    jk, jdiag = ref
    kps, diag = tas.detect_ast_keypoints(torch.from_numpy(img)[None], **KW, v1=True,
                                         with_diagnostics=True)
    for f in FIELDS:
        _same(getattr(kps, f)[0], getattr(jk, f), f)
    np.testing.assert_array_equal(diag.corner_counts[0].numpy(), np.asarray(jdiag.corner_counts))
    assert bool(diag.ok.all()) and bool(jdiag.ok)
    assert int(kps.valid.sum()) > 100
    # Layers 1 and 2 refine: the v1 gates differ from v2's on these candidates.
    v2 = tas.detect_ast_keypoints(torch.from_numpy(img)[None], **KW)
    assert not torch.equal(kps.valid, v2.valid)


def test_v1_facade_detect(img, ref):
    """``BriskFeatureDetector(version="v1")`` on one image and on a batch of
    it: the same keypoints (``detect_impl="dense"`` runs the candidates
    engine)."""
    jk, _ = ref
    for impl in ("candidates", "dense"):
        det = BriskFeatureDetector(**KW, version="v1", detect_impl=impl, device="cpu")
        kps = det.detect(torch.from_numpy(img))
        for f in FIELDS:
            _same(getattr(kps, f), getattr(jk, f), f)
    batch = det.detect(torch.from_numpy(np.stack([img, img])))
    assert torch.equal(batch.x[1], kps.x) and torch.equal(batch.valid[0], kps.valid)
