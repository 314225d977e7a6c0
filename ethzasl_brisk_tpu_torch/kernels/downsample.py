"""Pyramid down-sampling with the reference's exact integer rounding.

Port of ``kernels/downsample.py`` (``halfsample8``, ``twothirdsample8`` and
their 16-bit variants ``halfsample16``, ``twothirdsample16``): every
pairwise average is ``(a + b + 1) >> 1`` in int32
(test-downsampling.cc:67-140; image-down-sampling.cc:56, :394 for 16 bits).
Inputs are cast to int32 first because torch uint8 arithmetic wraps. Works
on ``(..., H, W)`` uint8 or uint16 tensors. ``halfsample8_v1`` and
``twothirdsample8_v1`` are the v1 engine's own uint8 resamplers, with
their own rounding (see their section below).
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


# ---------------------------------------------------------------------------
# The BRISK v1 engine's own resamplers (brisk-v1.cc:1847-2072; the JAX
# package's ``halfsample8_v1`` and ``twothirdsample8_v1``). Their SSE code
# rounds through saturating avg_epu8 chains, its 15->10 two-thirds shuffle
# reads column 12 where column 13 would be expected (mask1/mask2 at
# :1989-1990), and its scalar tails round differently from the main path:
# the odd trailing 16-px block of the half sample halves with a truncating
# //2, and the leftover columns take //4 and //9 of the raw rows.
# ---------------------------------------------------------------------------

_V1_T2 = (0, 2, 3, 5, 6, 8, 9, 11, 12, 14)
_V1_T1 = (1, 1, 4, 4, 7, 7, 10, 10, 12, 12)


def twothirdsample8_v1(img: torch.Tensor) -> torch.Tensor:
    """uint8 (..., H, W) -> uint8 (..., 2*(H//3), 2*(W//3)), v1 rounding
    (brisk_v1::BriskLayer::twothirdsample, brisk-v1.cc:1984-2072): vertical
    avg(avg(a, b), a) chains, the 15->10 shuffle and average per SIMD
    group, and an exact //9 weighted average of the raw rows on the
    leftover columns."""
    *lead, h, w = img.shape
    k = h // 3
    hsize = w // 15
    leftover = ((w // 3) * 3) % 15
    s = img.to(torch.int32)
    a_row = s[..., 0 : 3 * k : 3, :]
    b_row = s[..., 1 : 3 * k : 3, :]
    c_row = s[..., 2 : 3 * k : 3, :]
    up = _avg_round_up(_avg_round_up(a_row, b_row), a_row)
    lo = _avg_round_up(_avg_round_up(c_row, b_row), c_row)

    base = torch.arange(hsize, device=img.device)[:, None] * 15
    i_t2 = (base + torch.tensor(_V1_T2, device=img.device)).reshape(-1)
    i_t1 = (base + torch.tensor(_V1_T1, device=img.device)).reshape(-1)

    def horiz(v):  # (..., k, w) -> (..., k, 10*hsize)
        t2 = v[..., i_t2]
        return _avg_round_up(_avg_round_up(t2, v[..., i_t1]), t2)

    c0 = 15 * hsize
    up_cols, lo_cols = [horiz(up)], [horiz(lo)]
    for j in range(0, leftover, 3):
        a1, a2, a3 = (a_row[..., c0 + j + t] for t in range(3))
        b1, b2, b3 = (b_row[..., c0 + j + t] for t in range(3))
        c1, c2, c3 = (c_row[..., c0 + j + t] for t in range(3))
        up_cols.append(torch.stack([(4 * a1 + 2 * (a2 + b1) + b2) // 9,
                                    (4 * a3 + 2 * (a2 + b3) + b2) // 9], dim=-1))
        lo_cols.append(torch.stack([(4 * c1 + 2 * (c2 + b1) + b2) // 9,
                                    (4 * c3 + 2 * (c2 + b3) + b2) // 9], dim=-1))
    out = torch.stack([torch.cat(up_cols, dim=-1), torch.cat(lo_cols, dim=-1)], dim=-2)
    return (out.reshape(*lead, 2 * k, 2 * (w // 3)) & 0xFF).to(torch.uint8)


def halfsample8_v1(img: torch.Tensor) -> torch.Tensor:
    """uint8 (..., H, W) -> uint8 (..., H//2, W//2), v1 rounding
    (brisk_v1::BriskLayer::halfsample, brisk-v1.cc:1847-1982): avg_epu8
    vertically and horizontally over 32-px double blocks; the odd trailing
    16-px block averages horizontally with a truncating //2; the leftover
    columns take overlapping (a[k] + a[k+1] + b[k] + b[k+1]) // 4."""
    h, w = img.shape[-2:]
    dh = h // 2
    hsize = w // 16
    end = hsize // 2
    leftover = (w % 16) // 2
    s = img.to(torch.int32)
    a_row = s[..., 0 : 2 * dh : 2, :]
    b_row = s[..., 1 : 2 * dh : 2, :]
    v = _avg_round_up(a_row, b_row)
    cols = []
    c = 32 * end
    if end:
        cols.append(_avg_round_up(v[..., :c:2], v[..., 1:c:2]))
    if hsize % 2 == 1:
        blk = v[..., c : c + 16]
        cols.append((blk[..., 0::2] + blk[..., 1::2]) // 2)
        c += 16
    for kk in range(leftover):
        cols.append(((a_row[..., c + kk] + a_row[..., c + kk + 1]
                      + b_row[..., c + kk] + b_row[..., c + kk + 1]) // 4)[..., None])
    return (torch.cat(cols, dim=-1) & 0xFF).to(torch.uint8)
