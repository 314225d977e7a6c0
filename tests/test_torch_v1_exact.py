"""Port parity: the v1 engine's detection with the ``exact`` cache model and
in the non-suppressed mode, against the JAX package.

The inputs of ``test_torch_v1_detect.py`` (a 96 x 128 smoothed-noise crop,
octaves 2, threshold 40). The JAX functions run op by op under
``jax.enable_x64(True)``. Tolerance: bit for bit on every field of every
slot.
"""
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.detect import ast_scale_space as jas  # noqa: E402
from ethzasl_brisk_tpu_torch.detect import ast_scale_space as tas  # noqa: E402

from .test_torch_v1_detect import FIELDS, KW, _same, img  # noqa: E402,F401


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port on one thread here: tier-1 runs six workers on few cores,
    and the JAX reference's compiles take the rest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kw", [dict(raw_cache_model="exact"),
                                dict(suppress_scale_nonmaxima=False)],
                         ids=["exact", "not_suppressed"])
def test_v1_mode_bitwise(img, kw):
    with jax.enable_x64(True):
        ref = jas.detect_ast_keypoints(jnp.asarray(img), **KW, **kw, v1=True)
    kps = tas.detect_ast_keypoints(torch.from_numpy(img)[None], **KW, **kw, v1=True)
    for f in FIELDS:
        _same(getattr(kps, f)[0], getattr(ref, f), f)
    assert int(kps.valid.sum()) > 100
    emulated = tas.detect_ast_keypoints(torch.from_numpy(img)[None], **KW, v1=True)
    if "raw_cache_model" in kw:
        assert int((kps.valid != emulated.valid).sum()) < 10  # the models agree but for ties
