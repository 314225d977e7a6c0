"""Port parity: the v1 engine against the JAX package's dense engine.

``detect_impl="dense"`` is a checked no-op in the port: it runs the
candidates engine, which the JAX package holds bitwise equal to its dense
engine for v1 too (``tests/test_ast_dense.py:148``). Here the port's
``BriskFeatureDetector(version="v1", detect_impl="dense")`` is held against
``detect_ast_keypoints_dense(..., v1=True)`` itself, op by op under
``jax.enable_x64(True)``, on the crop of ``test_torch_v1_detect.py`` at
octaves 1 (layer 0's Refine3D with the AGAST 5/8 virtual below and the
last layer; octaves 2 takes the JAX engine ~90 s to compile op by op).
Tolerance: bit for bit on every field of every slot.
"""
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.detect.ast_dense import detect_ast_keypoints_dense  # noqa: E402
from ethzasl_brisk_tpu_torch import BriskFeatureDetector  # noqa: E402

from .test_torch_v1_detect import FIELDS, KW, _same, img  # noqa: E402,F401


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port on one thread here: tier-1 runs six workers on few cores,
    and the JAX reference's compiles take the rest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_v1_dense_bitwise(img):
    kw = dict(KW, octaves=1)
    with jax.enable_x64(True):
        ref = detect_ast_keypoints_dense(jnp.asarray(img), **kw, v1=True)
    det = BriskFeatureDetector(**kw, version="v1", detect_impl="dense", device="cpu")
    kps = det.detect(torch.from_numpy(img))
    for f in FIELDS:
        _same(getattr(kps, f), getattr(ref, f), f)
    assert int(kps.valid.sum()) > 100
