"""Port parity: ``detect_ast_keypoints`` with per-layer caps and passed
keypoints.

A 160 x 212 smoothed-noise crop at octaves 2 (corner counts 1667, 507, 203
and 50, the crop of ``tests/test_ast_parity.py``'s per-layer test), under
``jax.enable_x64(True)`` (the reference's double sites in double, as in
the port), the JAX functions op by op: the ``emulated`` model with
per-layer caps and its diagnostics, and the passed-keypoints mode
(``compute_scale``'s), suppressed and not. Tolerance: bit for bit on every
field of every slot. The passed keypoints are the detector's own output
and seeded random ones, valid and not, some outside the frame; all
coordinates are finite (a non-finite or huge coordinate has no defined
int32 on either device). The caps and the passed capacity share one slot
count, so the JAX functions compile for few shapes.
"""
import numpy as np
import pytest
import torch
from scipy import ndimage

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.core.keypoints import KeyPoints as JaxKeyPoints  # noqa: E402
from ethzasl_brisk_tpu.detect import ast_scale_space as jas  # noqa: E402
from ethzasl_brisk_tpu_torch import KeyPoints  # noqa: E402
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
CAPS = (2048, 1024, 1024, 1024)
N_PASSED = 1024
KW = dict(threshold=40, octaves=2)


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
    base = np.random.default_rng(31).integers(0, 256, (160, 212)).astype(np.float32)
    return np.clip(ndimage.convolve(base, np.ones((3, 3)) / 9.0, mode="nearest"),
                   0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def port(img):
    return tas.detect_ast_keypoints(torch.from_numpy(img)[None], **KW,
                                    max_candidates_per_layer=CAPS, with_diagnostics=True)


def test_per_layer_caps_bitwise(img, port):
    with jax.enable_x64(True):
        ref, rdiag = jas.detect_ast_keypoints(jnp.asarray(img), **KW,
                                              max_candidates_per_layer=CAPS,
                                              with_diagnostics=True)
    kps, diag = port
    _same_kps(kps, ref)
    assert bool(diag.ok[0]) and bool(rdiag.ok)
    assert diag.corner_counts[0].tolist() == [1667, 507, 203, 50]
    _same(diag.cand_caps, rdiag.cand_caps, "caps")
    assert kps.capacity == sum(CAPS)


def _passed(port):
    """768 of the detector's own valid keypoints, then seeded random ones
    (a quarter invalid; some outside the frame)."""
    kps = port[0]
    v = kps.valid[0]
    own = {f: getattr(kps, f)[0][v].numpy()[:768] for f in ("x", "y", "size")}
    n_own = len(own["x"])
    rng = np.random.default_rng(3)
    n = N_PASSED - n_own
    x = np.concatenate([own["x"], rng.uniform(-20, 232, n)]).astype(np.float32)
    y = np.concatenate([own["y"], rng.uniform(-20, 180, n)]).astype(np.float32)
    size = np.concatenate([own["size"], rng.uniform(8, 40, n)]).astype(np.float32)
    valid = np.concatenate([np.ones(n_own, bool), rng.random(n) < 0.75])
    angle = np.full(N_PASSED, -1.0, np.float32)
    zeros = np.zeros(N_PASSED, np.float32)
    jk = JaxKeyPoints(x=jnp.asarray(x), y=jnp.asarray(y), size=jnp.asarray(size),
                      angle=jnp.asarray(angle), response=jnp.asarray(zeros),
                      octave=jnp.zeros(N_PASSED, jnp.int32), valid=jnp.asarray(valid))
    tk = KeyPoints(*(torch.from_numpy(np.array(getattr(jk, f)))[None] for f in FIELDS))
    return jk, tk


@pytest.mark.parametrize("suppress", [True, False])
def test_passed_keypoints_bitwise(port, img, suppress):
    jk, tk = _passed(port)
    kw = dict(KW, suppress_scale_nonmaxima=suppress, lower_threshold=0)
    with jax.enable_x64(True):
        ref = jas.detect_ast_keypoints(jnp.asarray(img), **kw, passed_keypoints=jk)
    got = tas.detect_ast_keypoints(torch.from_numpy(img)[None], **kw, passed_keypoints=tk)
    _same_kps(got, ref)
    assert got.capacity == 4 * N_PASSED
    assert int(got.valid.sum()) > 200
