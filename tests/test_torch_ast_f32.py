"""Port parity: ``detect_ast_keypoints`` against the JAX package's default
float32 mode.

The port computes the reference's double sites (``_dbl``, ``_dbl_div``) in
float64, which is the JAX package under ``jax.enable_x64(True)`` and is
held bit for bit elsewhere. Without x64 the JAX package computes those
sites in float32. On a 160 x 212 smoothed-noise crop at octaves 2 (the
crop of ``tests/test_torch_ast_modes.py``) ``valid``, ``octave``,
``size``, ``response`` and ``angle`` are equal on every slot, and x and y
are within 2 ULP: the gap measured between the JAX package's two modes.
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


CAPS = (2048, 1024, 1024, 1024)
ULP = 2


@pytest.fixture(scope="module")
def img():
    base = np.random.default_rng(31).integers(0, 256, (160, 212)).astype(np.float32)
    return np.clip(ndimage.convolve(base, np.ones((3, 3)) / 9.0, mode="nearest"),
                   0, 255).astype(np.uint8)


@pytest.mark.parametrize("model", ["emulated", "cache"])
def test_against_jax_default_float32(img, model):
    assert not jax.config.jax_enable_x64
    kw = dict(threshold=40, octaves=2, max_candidates_per_layer=CAPS, raw_cache_model=model)
    ref = jas.detect_ast_keypoints(jnp.asarray(img), **kw)
    kps = tas.detect_ast_keypoints(torch.from_numpy(img)[None], **kw)
    for f in ("valid", "octave", "size", "response", "angle"):
        np.testing.assert_array_equal(getattr(kps, f)[0].numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    for f in ("x", "y"):
        a = getattr(kps, f)[0].numpy().view(np.int32).astype(np.int64)
        b = np.asarray(getattr(ref, f)).view(np.int32).astype(np.int64)
        assert int(np.abs(a - b).max()) <= ULP, f
    assert int(kps.valid.sum()) > 1000
