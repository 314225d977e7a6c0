"""Pyramid down-sampling with the reference's exact integer rounding.

Port of ``kernels/downsample.py`` (``halfsample8``, ``twothirdsample8`` and
their 16-bit variants ``halfsample16``, ``twothirdsample16``): every
pairwise average is ``(a + b + 1) >> 1`` in int32
(test-downsampling.cc:67-140; image-down-sampling.cc:56, :394 for 16 bits).
Inputs are cast to int32 first because torch uint8 arithmetic wraps. Works
on ``(..., H, W)`` uint8 or uint16 tensors.
"""
from __future__ import annotations

import torch


def _avg_round_up(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a + b + 1) >> 1


def _halfsample(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> int32 (..., H//2, W//2) rounded 2x2 averages."""
    *lead, h, w = img.shape
    h2, w2 = h // 2, w // 2
    v = img[..., : 2 * h2, : 2 * w2].to(torch.int32)
    blocks = v.reshape(*lead, h2, 2, w2, 2)
    col0 = _avg_round_up(blocks[..., :, 0, :, 0], blocks[..., :, 1, :, 0])
    col1 = _avg_round_up(blocks[..., :, 0, :, 1], blocks[..., :, 1, :, 1])
    return _avg_round_up(col0, col1)


def halfsample8(img: torch.Tensor) -> torch.Tensor:
    """uint8 (..., H, W) -> uint8 (..., H//2, W//2), reference rounding."""
    return torch.clamp(_halfsample(img), max=255).to(torch.uint8)


def halfsample16(img: torch.Tensor) -> torch.Tensor:
    """uint16 (..., H, W) -> uint16 (..., H//2, W//2) (Halfsample16)."""
    return torch.clamp(_halfsample(img), max=65535).to(torch.uint16)


def _twothirdsample(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> int32 (..., H//3*2, W//3*2) blends.

    Each 3x3 block {A, B, C rows} gives a 2x2 output: rows blend as
    ((A+B+1)/2 + A + 1)/2 (upper) and the same with C (lower), then the
    same blend horizontally.
    """
    *lead, h, w = img.shape
    h3, w3 = h // 3, w // 3
    v = img[..., : 3 * h3, : 3 * w3].to(torch.int32)
    b = v.reshape(*lead, h3, 3, w3, 3)
    a_row, b_row, c_row = b[..., :, 0, :, :], b[..., :, 1, :, :], b[..., :, 2, :, :]
    upper = _avg_round_up(_avg_round_up(a_row, b_row), a_row)  # (..., bh, bw, 3)
    lower = _avg_round_up(_avg_round_up(c_row, b_row), c_row)

    def blend_h(row):  # (..., bh, bw, 3) -> (..., bh, bw, 2)
        left = _avg_round_up(_avg_round_up(row[..., 0], row[..., 1]), row[..., 0])
        right = _avg_round_up(_avg_round_up(row[..., 2], row[..., 1]), row[..., 2])
        return torch.stack([left, right], dim=-1)

    out = torch.stack([blend_h(upper), blend_h(lower)], dim=-3)  # (..., bh, 2, bw, 2)
    return out.reshape(*lead, 2 * h3, 2 * w3)


def twothirdsample8(img: torch.Tensor) -> torch.Tensor:
    """uint8 (..., H, W) -> uint8 (..., H//3*2, W//3*2), reference rounding;
    the result keeps the intended ``& 0xFF``."""
    return (_twothirdsample(img) & 0xFF).to(torch.uint8)


def twothirdsample16(img: torch.Tensor) -> torch.Tensor:
    """uint16 (..., H, W) -> uint16 (..., H//3*2, W//3*2)
    (Twothirdsample16), keeping ``& 0xFFFF``."""
    return (_twothirdsample(img) & 0xFFFF).to(torch.uint16)
