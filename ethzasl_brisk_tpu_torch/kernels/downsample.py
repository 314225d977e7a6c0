"""Pyramid down-sampling with the reference's exact integer rounding.

Port of ``kernels/downsample.py`` (``halfsample8``, ``twothirdsample8`` and
their 16-bit variants ``halfsample16``, ``twothirdsample16``): every
pairwise average is ``(a + b + 1) >> 1`` in int32
(test-downsampling.cc:67-140; image-down-sampling.cc:56, :394 for 16 bits).
Inputs are cast to int32 first because torch uint8 arithmetic wraps. Works
on ``(..., H, W)`` uint8 or uint16 tensors. ``halfsample8_v1`` and
``twothirdsample8_v1`` are the v1 engine's own uint8 resamplers, with
their own rounding (see their section below).

``pyramid_u8`` builds every derived layer of a uint8 scale-space pyramid
(layer 1 the two-thirds sample of the frames, layer i >= 2 the half sample
of layer i - 2): kernel ``pyramid_u8`` of ``csrc/pyramid.cu``, one launch
for every layer, on CUDA tensors (or it raises); ``pyramid_u8_plain``, the
resamplers above one layer after the other, on CPU tensors;
``pyramid_u8_twin`` the kernel's tiles in torch (the frames zero-padded to
whole tiles, each tile resampled on its own, each layer cropped to its
floored size), held against the plain version on the CPU. The uint16 and
v1 resamplers stay torch ops.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ethzasl_brisk_tpu_torch import _kernels

# csrc/pyramid.cu: a CTA takes a PYRAMID_TILE (rows, columns) tile of the
# frame, whose sides are multiples of 3 * 2^4, so every layer up to
# MAX_PYRAMID_LAYERS is whole blocks of its source's tile. The layers of a
# call share one output buffer, each starting at a multiple of LAYER_ALIGN
# bytes.
PYRAMID_TILE = (48, 96)
MAX_PYRAMID_LAYERS = 10
LAYER_ALIGN = 256


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


# ---------------------------------------------------------------------------
# Every derived uint8 layer in one launch (kernel pyramid_u8).
# ---------------------------------------------------------------------------

def layer_sizes(h: int, w: int, n_layers: int) -> list[tuple[int, int]]:
    """Each layer's floored (rows, columns): the frame's, two thirds of it,
    then half of the layer two below."""
    sizes = [(h, w)]
    for i in range(1, n_layers):
        if i == 1:
            sizes.append((2 * (h // 3), 2 * (w // 3)))
        else:
            sizes.append((sizes[i - 2][0] // 2, sizes[i - 2][1] // 2))
    return sizes


def pyramid_u8_plain(imgs: torch.Tensor, n_layers: int) -> list[torch.Tensor]:
    """Plain version: [imgs, twothirdsample8(imgs), halfsample8(imgs),
    halfsample8(layer 1), ...], one resampler call a layer."""
    layers = [imgs]
    for i in range(1, n_layers):
        layers.append(twothirdsample8(imgs) if i == 1 else halfsample8(layers[i - 2]))
    return layers


def _frames_of(imgs: torch.Tensor, n_layers: int, what: str):
    if imgs.dtype != torch.uint8 or imgs.dim() < 2:
        raise ValueError(f"{what}: expected uint8 (..., H, W) frames, got {imgs.dtype} "
                         f"{tuple(imgs.shape)}")
    if n_layers > MAX_PYRAMID_LAYERS:
        raise ValueError(f"{what}: {n_layers} layers, at most {MAX_PYRAMID_LAYERS}")
    *lead, h, w = imgs.shape
    return imgs.reshape(math.prod(lead), h, w), tuple(lead), h, w


def layer_buffer(lead: tuple, sizes: list, device) -> list[torch.Tensor]:
    """The derived layers' outputs as views of one uint8 buffer, each
    (*lead, h, w) contiguous and starting at a multiple of LAYER_ALIGN."""
    b = math.prod(lead)
    offsets, total = [], 0
    for h, w in sizes[1:]:
        offsets.append(total)
        total += -(-b * h * w // LAYER_ALIGN) * LAYER_ALIGN
    buf = torch.empty(total, dtype=torch.uint8, device=device)
    return [buf[o : o + b * h * w].view(*lead, h, w) for o, (h, w) in zip(offsets, sizes[1:])]


def pyramid_u8_twin(imgs: torch.Tensor, n_layers: int) -> list[torch.Tensor]:
    """The kernel's algorithm in torch: the frames zero-padded to whole
    ``PYRAMID_TILE`` tiles, every tile resampled on its own (layer 1 from
    the frame's tile, layer i from layer i - 2's tile), each layer's tiles
    put side by side and cropped to the layer's floored size, into the
    kernel's one output buffer."""
    frames, lead, h, w = _frames_of(imgs, n_layers, "pyramid_u8_twin")
    if n_layers <= 1:
        return [imgs]
    b = frames.shape[0]
    (th, tw), tiles = PYRAMID_TILE, layer_sizes(*PYRAMID_TILE, n_layers)
    ny, nx = -(-h // th), -(-w // tw)
    canvas = torch.zeros((b, ny * th, nx * tw), dtype=torch.int32, device=imgs.device)
    canvas[:, :h, :w] = frames
    tiled = [canvas.view(b, ny, th, nx, tw).permute(0, 1, 3, 2, 4)]  # (b, ny, nx, th, tw)
    for i in range(1, n_layers):
        tiled.append(_twothirdsample(tiled[0]) & 0xFF if i == 1
                     else torch.clamp(_halfsample(tiled[i - 2]), max=255))
        assert tuple(tiled[i].shape[-2:]) == tiles[i], (i, tuple(tiled[i].shape))
    sizes = layer_sizes(h, w, n_layers)
    outs = layer_buffer(lead, sizes, imgs.device)
    for i, out in enumerate(outs, start=1):
        a, c = tiles[i]
        whole = tiled[i].permute(0, 1, 3, 2, 4).reshape(b, ny * a, nx * c)
        out.copy_(whole[:, : sizes[i][0], : sizes[i][1]].reshape(out.shape))
    return [imgs, *outs]


def pyramid_u8_cuda(imgs: torch.Tensor, n_layers: int) -> list[torch.Tensor]:
    """Kernel ``pyramid_u8``: every derived layer of uint8 (..., H, W)
    frames on the card in one launch, none for one layer or no output
    pixel. Layer 0 is ``imgs`` itself; strided frames are copied once."""
    frames, lead, h, w = _frames_of(imgs, n_layers, "pyramid_u8_cuda")
    if imgs.device.type != "cuda":
        raise ValueError(f"pyramid_u8_cuda needs a CUDA tensor, got {imgs.device}")
    if n_layers <= 1:
        return [imgs]
    sizes = layer_sizes(h, w, n_layers)
    outs = layer_buffer(lead, sizes, imgs.device)
    if any(o.numel() for o in outs):
        frames = frames.contiguous()
        table = (ctypes.c_int64 * (3 * len(outs)))(
            *(v for o, (a, c) in zip(outs, sizes[1:]) for v in (o.data_ptr(), a, c)))
        _kernels.launch("pyramid_u8", "pyramid_u8", imgs.device, frames.data_ptr(), table,
                        n_layers, frames.shape[0], h, w)
    return [imgs, *outs]


def pyramid_u8(imgs: torch.Tensor, n_layers: int) -> list[torch.Tensor]:
    """The uint8 pyramid's layers [imgs, layer 1, ..., layer n-1]: kernel
    ``pyramid_u8`` (one launch) for CUDA tensors, ``pyramid_u8_plain`` for
    CPU tensors."""
    if imgs.device.type == "cpu":
        return pyramid_u8_plain(imgs, n_layers)
    return pyramid_u8_cuda(imgs, n_layers)
