"""Harris corner scores with the reference's exact integer fixed-point math.

Port of ``kernels/harris.py`` (the plain ``harris_score_i32``) and
``kernels/pallas_harris.py`` (the fused TPU kernel, here the CUDA kernel
in ``csrc/harris.cu``). Reference: ``brisk/src/harris-scores.cc:53-279``:

  1. Scharr gradients x8: dx = (10*(L-R) + 3*(UL-UR) + 3*(LL-LR)) << 3;
  2. products (a*b) >> 16;
  3. 3x3 binomial smoothing (4c + 2*edge + corner) >> 4;
  4. score = sxx*syy - sxy^2 - (((sxx+syy) >> 1)^2 >> 2), int32.

Gradients live on rows/cols [1, n-2], scores on [2, n-3], zero elsewhere.
torch's ``>>`` on int32 is an arithmetic shift, as in C.

``harris_score_i32_layers`` is what the pipeline calls: CUDA layers go
through one launch of the kernel for the whole pyramid (or raise), CPU
layers through the plain version; ``harris_score_i32_fused`` is its
one-layer form.
``harris_score_mask_layers`` (kernel K3, the same source's masked body;
JAX ``harris_score_mask_fused``) adds the 2-D maxima mask in the same pass,
one launch for the pyramid; the ``fused_mask`` detector setting calls it,
and ``harris_score_mask_fused`` is its one-layer form.
``harris_score_f32`` is the 16-bit pipeline's float score (JAX
``harris_score_f32``), torch ops on either device: the JAX package runs it
in XLA, with no TPU kernel.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ethzasl_brisk_tpu_torch import _kernels
from ethzasl_brisk_tpu_torch.kernels.nms import maxima2d_mask

_MAX_LAYERS = 8  # the layer table of csrc/harris.cu (K1 and K3)


def _shift(p: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., i, j] = p[..., i+dy, j+dx], zero outside."""
    h, w = p.shape[-2:]
    padded = F.pad(p, (1, 1, 1, 1))
    return padded[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]


def _border_mask(h: int, w: int, b: int, device) -> torch.Tensor:
    m = torch.zeros((h, w), dtype=torch.bool, device=device)
    m[b : h - b, b : w - b] = True
    return m


def _smooth3x3_shift4(v: torch.Tensor) -> torch.Tensor:
    s = (
        4 * v
        + 2 * (_shift(v, -1, 0) + _shift(v, 1, 0) + _shift(v, 0, -1) + _shift(v, 0, 1))
        + _shift(v, -1, -1) + _shift(v, -1, 1) + _shift(v, 1, -1) + _shift(v, 1, 1)
    )
    return s >> 4


def harris_score_i32(img: torch.Tensor) -> torch.Tensor:
    """Plain version: uint8 (..., H, W) -> int32 (..., H, W) Harris scores."""
    h, w = img.shape[-2:]
    p = img.to(torch.int32)
    n = {
        (dy, dx): _shift(p, dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
    }
    dx = (
        10 * (n[(0, -1)] - n[(0, 1)])
        + 3 * (n[(-1, -1)] - n[(-1, 1)])
        + 3 * (n[(1, -1)] - n[(1, 1)])
    ) << 3
    dy = (
        10 * (n[(-1, 0)] - n[(1, 0)])
        + 3 * (n[(-1, -1)] - n[(1, -1)])
        + 3 * (n[(-1, 1)] - n[(1, 1)])
    ) << 3
    interior = _border_mask(h, w, 1, img.device)
    zero = torch.zeros((), dtype=torch.int32, device=img.device)
    dx = torch.where(interior, dx, zero)
    dy = torch.where(interior, dy, zero)

    sxx = _smooth3x3_shift4((dx * dx) >> 16)
    syy = _smooth3x3_shift4((dy * dy) >> 16)
    sxy = _smooth3x3_shift4((dx * dy) >> 16)
    trace_half = (sxx + syy) >> 1
    score = sxx * syy - sxy * sxy - ((trace_half * trace_half) >> 2)
    return torch.where(_border_mask(h, w, 2, img.device), score, zero)


def harris_score_f32(img: torch.Tensor) -> torch.Tensor:
    """Float Harris scores (HarrisScoreCalculatorFloat semantics, the
    16-bit pipeline's): (..., H, W) -> float32 (..., H, W).

    Scharr/16 gradients, the [[1, 2, 1], [2, 4, 2], [1, 2, 1]]/16 smoothing
    of their products and det - trace^2/16
    (harris-score-calculator-float.cc:53-57), as elementwise shifts and
    adds in the JAX package's order of operations: every op rounds on its
    own, so the maps equal the JAX function run eagerly bit for bit (a
    convolution would sum in another order).
    """
    h, w = img.shape[-2:]
    p = img.to(torch.float32)
    n = {
        (dy, dx): _shift(p, dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
    }
    gx = (
        10.0 * (n[(0, -1)] - n[(0, 1)])
        + 3.0 * (n[(-1, -1)] - n[(-1, 1)])
        + 3.0 * (n[(1, -1)] - n[(1, 1)])
    ) / 16.0
    gy = (
        10.0 * (n[(-1, 0)] - n[(1, 0)])
        + 3.0 * (n[(-1, -1)] - n[(1, -1)])
        + 3.0 * (n[(-1, 1)] - n[(1, 1)])
    ) / 16.0
    interior = _border_mask(h, w, 1, img.device)
    zero = torch.zeros((), dtype=torch.float32, device=img.device)
    gx = torch.where(interior, gx, zero)
    gy = torch.where(interior, gy, zero)

    def smooth(v):
        s = (
            4.0 * v
            + 2.0 * (_shift(v, -1, 0) + _shift(v, 1, 0) + _shift(v, 0, -1) + _shift(v, 0, 1))
            + _shift(v, -1, -1) + _shift(v, -1, 1) + _shift(v, 1, -1) + _shift(v, 1, 1)
        )
        return s / 16.0

    sxx, syy, sxy = smooth(gx * gx), smooth(gy * gy), smooth(gx * gy)
    trace = sxx + syy
    score = sxx * syy - sxy * sxy - trace * trace / 16.0
    return torch.where(_border_mask(h, w, 2, img.device), score, zero)


def _check_frames(imgs: torch.Tensor, name: str) -> None:
    """The kernels take contiguous uint8 (B, H, W) CUDA tensors only."""
    if imgs.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got {imgs.device}")
    if imgs.dtype != torch.uint8 or imgs.dim() != 3 or not imgs.is_contiguous():
        raise ValueError(
            f"expected contiguous uint8 (B, H, W), got {imgs.dtype} {tuple(imgs.shape)}"
        )


def _layer_chunks(name: str, layers: list[torch.Tensor],
                  outputs: list[tuple[torch.Tensor, ...]]):
    """The launches over the non-empty layers, up to 8 layers each: per
    launch the card and the layer table's arguments (the layers' pointers,
    then each output's, their (B, H, W) and the count)."""
    work = [(im, outs) for im, outs in zip(layers, outputs) if im.numel()]
    if any(im.device != work[0][0].device for im, _ in work):
        raise ValueError(f"{name}: layers on more than one card")
    for i in range(0, len(work), _MAX_LAYERS):
        chunk = work[i : i + _MAX_LAYERS]
        n = len(chunk)
        ptrs = [(ctypes.c_void_p * n)(*(t.data_ptr() for t in col))
                for col in zip(*((im, *outs) for im, outs in chunk))]
        dims = (ctypes.c_int * (3 * n))(*(d for im, _ in chunk for d in im.shape))
        yield chunk[0][0].device, (*ptrs, dims, n)


def harris_score_i32_layers_cuda(layers: list[torch.Tensor]) -> list[torch.Tensor]:
    """Kernel K1 on pyramid layers in one launch (up to 8 layers a launch):
    uint8 (B, H, W) CUDA tensors on one card -> int32 (B, H, W) scores."""
    for im in layers:
        _check_frames(im, "harris_score_i32_layers_cuda")
    outs = [torch.empty(im.shape, dtype=torch.int32, device=im.device) for im in layers]
    for dev, args in _layer_chunks("harris_score_i32_layers_cuda", layers, [(o,) for o in outs]):
        _kernels.launch("harris_score_layers", "harris_score_i32", dev, *args)
    return outs


def harris_score_i32_cuda(imgs: torch.Tensor) -> torch.Tensor:
    """Kernel K1: uint8 (B, H, W) CUDA tensor -> int32 (B, H, W) scores."""
    return harris_score_i32_layers_cuda([imgs])[0]


def harris_score_i32_fused(imgs: torch.Tensor) -> torch.Tensor:
    """(B, H, W) uint8 -> int32 scores: the CUDA kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    if imgs.device.type == "cpu":
        return harris_score_i32(imgs)
    return harris_score_i32_cuda(imgs.contiguous())


def harris_score_i32_layers(layers: list[torch.Tensor]) -> list[torch.Tensor]:
    """Scores of every pyramid layer: one K1 launch for CUDA tensors, the
    plain version of each layer for CPU tensors."""
    if all(im.device.type == "cpu" for im in layers):
        return [harris_score_i32(im) for im in layers]
    return harris_score_i32_layers_cuda([im.contiguous() for im in layers])


def harris_score_mask_i32(imgs: torch.Tensor, thr: int):
    """Plain version of kernel K3: (scores, 2-D maxima mask), each (..., H, W).

    The Harris scores followed by ``maxima2d_mask`` (border 2), which is
    what the JAX package's ``harris_score_mask_fused`` computes off the TPU.
    """
    sc = harris_score_i32(imgs)
    return sc, maxima2d_mask(sc, thr)


def harris_score_mask_layers_cuda(layers: list[torch.Tensor], thr: int):
    """Kernel K3 on pyramid layers in one launch (up to 8 layers a launch):
    uint8 (B, H, W) CUDA tensors on one card -> (int32 scores, bool mask)
    per layer, one threshold for all."""
    for im in layers:
        _check_frames(im, "harris_score_mask_layers_cuda")
    thr = int(thr)
    i32 = torch.iinfo(torch.int32)
    if not i32.min <= thr <= i32.max:
        raise ValueError(f"threshold {thr} does not fit int32")
    pairs = [(torch.empty(im.shape, dtype=torch.int32, device=im.device),
              torch.empty(im.shape, dtype=torch.bool, device=im.device)) for im in layers]
    for dev, args in _layer_chunks("harris_score_mask_layers_cuda", layers, pairs):
        _kernels.launch("harris_score_mask_layers", "harris_score_mask", dev, *args, thr)
    return pairs


def harris_score_mask_layers(layers: list[torch.Tensor], thr: int):
    """(scores, 2-D maxima mask) of every pyramid layer: one K3 launch for
    CUDA tensors, the plain version of each layer for CPU tensors."""
    if all(im.device.type == "cpu" for im in layers):
        return [harris_score_mask_i32(im, thr) for im in layers]
    return harris_score_mask_layers_cuda([im.contiguous() for im in layers], thr)


def harris_score_mask_cuda(imgs: torch.Tensor, thr: int):
    """Kernel K3: uint8 (B, H, W) CUDA tensor -> (int32 scores, bool mask)."""
    return harris_score_mask_layers_cuda([imgs], thr)[0]


def harris_score_mask_fused(imgs: torch.Tensor, thr: int):
    """(B, H, W) uint8 -> (int32 scores, bool 2-D maxima mask): kernel K3 on
    a CUDA tensor, the plain version on a CPU tensor."""
    return harris_score_mask_layers([imgs], thr)[0]
