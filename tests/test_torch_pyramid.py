"""Port parity: the uint8 scale-space pyramid, bit for bit.

On CPU tensors ``build_pyramid`` and the AST ``pyramid_images`` run
``pyramid_u8_plain``, the plain version of kernel ``pyramid_u8``
(``csrc/pyramid.cu``, held against it on the card in tests/test_torch_gpu.py
and chip_smoke.py ``[pyramid]``). Here both are held against the JAX
package's ``halfsample8`` / ``twothirdsample8`` in the JAX ``build_pyramid``'s
layer order, and ``pyramid_u8_twin``, the kernel's tiles in torch (zero
padding to whole 48 x 96 tiles, each tile resampled alone, each layer cropped
to its floored size, every layer in one buffer), against the plain version
on ragged shapes down to frames with empty layers.
"""
import functools
import pathlib
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.detect.scale_space import build_pyramid as jax_build_pyramid  # noqa: E402
from ethzasl_brisk_tpu.kernels import downsample as jds  # noqa: E402
from ethzasl_brisk_tpu_torch.detect import ast_scale_space as tas  # noqa: E402
from ethzasl_brisk_tpu_torch.detect import scale_space as tss  # noqa: E402
from ethzasl_brisk_tpu_torch.kernels import downsample as tds  # noqa: E402
from tests import _pyramid_cases as cases  # noqa: E402

SHAPES, SHAPE_IDS = list(cases.SHAPES), list(cases.IDS)
PYRAMID_CU = pathlib.Path(tds.__file__).resolve().parents[1] / "csrc" / "pyramid.cu"
_frames = cases.frames


@functools.lru_cache(maxsize=None)
def _jax_pyramid(n_layers):
    """The JAX build_pyramid over a batch of frames (jitted: op by op it
    compiles each op a shape)."""
    return jax.jit(jax.vmap(lambda f: jax_build_pyramid(f, n_layers)))


def _assert_layers(got, frames, n_layers):
    assert len(got) == n_layers
    for i, ref in enumerate(_jax_pyramid(n_layers)(jnp.asarray(frames))):
        assert got[i].dtype == torch.uint8
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref), err_msg=f"layer {i}")


@pytest.mark.parametrize("n_layers", cases.LAYERS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_build_pyramid_plain_matches_jax(shape, n_layers):
    frames = _frames(*shape)
    _assert_layers(tss.build_pyramid(torch.from_numpy(frames), n_layers), frames, n_layers)


@pytest.mark.parametrize("octaves", [1, 2, 3])
@pytest.mark.parametrize("shape", SHAPES[1:3], ids=SHAPE_IDS[1:3])
def test_ast_pyramid_images_plain_matches_jax(shape, octaves):
    """The AST pyramid (v2 resamplers): JAX build_ast_pyramid's images are
    JAX build_pyramid's layers at 2 * octaves."""
    frames = _frames(*shape)
    _assert_layers(tas.pyramid_images(torch.from_numpy(frames), octaves), frames, 2 * octaves)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_resamplers_match_jax(shape):
    frames = _frames(*shape)
    imgs, jimgs = torch.from_numpy(frames), jnp.asarray(frames)
    np.testing.assert_array_equal(tds.halfsample8(imgs).numpy(),
                                  np.asarray(jax.jit(jax.vmap(jds.halfsample8))(jimgs)))
    np.testing.assert_array_equal(tds.twothirdsample8(imgs).numpy(),
                                  np.asarray(jax.jit(jax.vmap(jds.twothirdsample8))(jimgs)))


@pytest.mark.parametrize("n_layers", [1, 2, 4, 6, 10])
@pytest.mark.parametrize("shape", SHAPES + [(1, 97, 193), (2, 48, 96), (1, 290, 17)],
                         ids=SHAPE_IDS + ["97x193", "one_tile", "290x17"])
def test_pyramid_twin_matches_plain(shape, n_layers):
    """The kernel's tile arithmetic against the plain chain, and its output
    layout: every derived layer a contiguous view of one buffer, each at a
    multiple of LAYER_ALIGN bytes."""
    imgs = torch.from_numpy(_frames(*shape))
    got, ref = tds.pyramid_u8_twin(imgs, n_layers), tds.pyramid_u8_plain(imgs, n_layers)
    assert len(got) == len(ref) == n_layers
    assert got[0] is imgs
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape, i
        assert torch.equal(g, r), f"layer {i}"
        assert g.is_contiguous()
    derived = got[1:]
    if derived:
        base = derived[0].untyped_storage().data_ptr()
        for g in derived:
            assert g.untyped_storage().data_ptr() == base
            if g.numel():
                assert (g.data_ptr() - base) % tds.LAYER_ALIGN == 0
    assert [tuple(g.shape[-2:]) for g in got] == tds.layer_sizes(*shape[1:], n_layers)


def test_pyramid_of_one_frame_and_strided_frames():
    """(H, W) frames keep their shape, and strided frames give the layers
    of their contiguous copy (the kernel's wrapper copies them once)."""
    frames = torch.from_numpy(_frames(3, 96, 130))
    for got, ref in zip(tds.pyramid_u8_twin(frames[1], 4), tds.pyramid_u8_plain(frames[1], 4)):
        assert torch.equal(got, ref)
    strided = frames[:, 1:90:2, ::3]
    assert not strided.is_contiguous()
    plain = tds.pyramid_u8_plain(strided.contiguous(), 6)
    for got in (tds.pyramid_u8_twin(strided, 6), tss.build_pyramid(strided, 6)):
        for g, r in zip(got, plain):
            assert torch.equal(g, r)


def test_pyramid_constants_match_the_kernel():
    src = PYRAMID_CU.read_text()
    tile = re.search(r"constexpr int kTileH = (\d+), kTileW = (\d+);", src)
    assert (int(tile[1]), int(tile[2])) == tds.PYRAMID_TILE
    assert int(re.search(r"constexpr int kMaxLayers = (\d+);", src)[1]) == tds.MAX_PYRAMID_LAYERS
    # Every layer's tile is whole blocks of its source's tile (the kernel's
    # whole_blocks): two thirds of the frame's, then half of the one two below.
    tiles = tds.layer_sizes(*tds.PYRAMID_TILE, tds.MAX_PYRAMID_LAYERS)
    assert tiles[1] == (32, 64) and tiles[-1] == (2, 4)
    for i, (a, c) in enumerate(tiles[1:], start=1):
        src, (num, den) = (tiles[0], (2, 3)) if i == 1 else (tiles[i - 2], (1, 2))
        assert (a * den, c * den) == (src[0] * num, src[1] * num), i


def test_pyramid_cuda_checks_its_arguments():
    frames = torch.from_numpy(_frames(2, 61, 83))
    with pytest.raises(ValueError, match="uint8"):
        tds.pyramid_u8_cuda(frames.to(torch.int16), 4)
    with pytest.raises(ValueError, match="at most"):
        tds.pyramid_u8_cuda(frames, tds.MAX_PYRAMID_LAYERS + 2)
    with pytest.raises(ValueError, match="CUDA"):
        tds.pyramid_u8_cuda(frames, 4)
