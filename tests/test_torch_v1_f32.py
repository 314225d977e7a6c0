"""Port parity: the v1 engine's detection against the JAX package's
default float32 mode.

The port computes the reference's double sites in float64, the JAX
package under ``jax.enable_x64(True)`` (held bit for bit in
``test_torch_v1_detect.py``). Without x64 the JAX package computes them
in float32; on the inputs of ``test_torch_v1_detect.py`` every field but x
and y is equal on every slot, and x and y are within 2 ULP, the bar of
``test_torch_ast_f32.py`` for the v2 engine.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.detect import ast_scale_space as jas  # noqa: E402
from ethzasl_brisk_tpu_torch.detect import ast_scale_space as tas  # noqa: E402

from .test_torch_v1_detect import KW, img  # noqa: E402,F401

ULP = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port on one thread here: tier-1 runs six workers on few cores,
    and the JAX reference's compiles take the rest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_v1_against_jax_default_float32(img):
    assert not jax.config.jax_enable_x64
    ref = jas.detect_ast_keypoints(jnp.asarray(img), **KW, v1=True)
    kps = tas.detect_ast_keypoints(torch.from_numpy(img)[None], **KW, v1=True)
    for f in ("valid", "octave", "size", "response", "angle"):
        np.testing.assert_array_equal(getattr(kps, f)[0].numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    for f in ("x", "y"):
        a = getattr(kps, f)[0].numpy().view(np.int32).astype(np.int64)
        b = np.asarray(getattr(ref, f)).view(np.int32).astype(np.int64)
        assert int(np.abs(a - b).max()) <= ULP, f
    assert int(kps.valid.sum()) > 100
