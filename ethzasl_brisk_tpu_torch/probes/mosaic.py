"""The TPU Mosaic probes' in-kernel building blocks on Hopper, each beside
its plain version.

``tools/probes/probe_mosaic_gather3.py`` and ``probe_mosaic_gather4.py``
time, besides lane gathers (G1, ``probes/gather.py``), three blocks a
describe sampler could be built from. Three functions serve them
(``csrc/probe_mosaic.cu``):

* T ``transpose_chain``: an int32 (m, 128) table in m / 128 square blocks,
  each taken through eight rounds of ``x = x.T; x = x + 1`` (``t + 8``;
  ``rounds`` sets another count, and an odd one gives ``x.T + rounds``);
* X ``gather_chain`` (replaces ``probe_mosaic_gather3.py:107`` ``chain``):
  per 128-row block, ``a = take_along_axis(t, i, 1)`` then
  ``take_along_axis(a.T, i, 1)``. Its two dependent reads per output fall
  at random places of the block, a 32-byte sector of L2 traffic each when
  read from device memory; the kernel stages the block's t and i (i
  transposed) in shared memory, a CTA a block, and serves every output from
  there, so the traffic is the bound's. It moves 16 bytes at a time: t, i
  and the output must be 16-byte aligned, and the wrapper raises otherwise;
* S ``window_colsum`` (replaces ``probe_mosaic_gather3.py:145`` and
  ``probe_mosaic_gather4.py:87`` ``dma_patches``): the column sums of K
  windows of 96 x 128 int32 at per-window offsets,
  ``out[k, c] = sum_r img[ay[k] + r, ax[k] + c]``. The windows overlap, so
  L2, not device memory, feeds it; a CTA of 256 threads a window keeps all
  of its rows in flight together, on any width and alignment.

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take. A CPU tensor takes the plain version; a CUDA
tensor launches the kernel (counted in ``_kernels.LAUNCHES``) or raises.
The kernels trust their indices to be in range; the plain versions check.
``*_bytes`` give the least device-memory traffic of a call on its inputs,
``*_ops`` its int32 operations (the bound of ``probes/cases.py``).
"""
from __future__ import annotations

import torch

from ethzasl_brisk_tpu_torch import _kernels, measure
from ethzasl_brisk_tpu_torch.probes.gather import _check_range, _device, _expect

BLOCK = 128
ROUNDS = 8
WIN_ROWS, WIN_COLS = 96, 128


def _blocks(name: str, *tables: torch.Tensor) -> int:
    """The number of 128 x 128 blocks of (m, 128) int32 tables of one shape."""
    _device(name, *tables)
    for t in tables:
        _expect(name, t, (torch.int32,), (2,))
    shape = tables[0].shape
    if any(t.shape != shape for t in tables) or shape[1] != BLOCK or shape[0] % BLOCK:
        raise ValueError(f"{name}: expected (m, {BLOCK}) tables with m a multiple of {BLOCK}, "
                         f"got {[tuple(t.shape) for t in tables]}")
    return shape[0] // BLOCK


# ---- T: transpose_chain.

def _rounds(rounds: int) -> int:
    if int(rounds) != rounds or rounds < 1:
        raise ValueError(f"transpose_chain: rounds must be a positive integer, got {rounds}")
    return int(rounds)


def transpose_chain_plain(t, rounds: int = ROUNDS) -> torch.Tensor:
    """Plain version of T: the transposes and adds of each block, step by
    step (int32 adds wrap)."""
    nblk = _blocks("transpose_chain", t)
    x = t.view(nblk, BLOCK, BLOCK)
    for _ in range(_rounds(rounds)):
        x = x.transpose(1, 2)
        x = x + 1
    return x.contiguous().view(t.shape)


def transpose_chain(t, rounds: int = ROUNDS) -> torch.Tensor:
    """T: each 128 x 128 block of an int32 (m, 128) table through ``rounds``
    rounds (the probe's 8) of transpose-then-add-1. Kernel on a CUDA
    tensor, plain version on a CPU one."""
    nblk = _blocks("transpose_chain", t)
    rounds = _rounds(rounds)
    if t.device.type == "cpu":
        return transpose_chain_plain(t, rounds)
    if t.data_ptr() % 16:
        raise ValueError("transpose_chain: the kernel reads 16-byte chunks; the table's "
                         "data must be 16-byte aligned")
    out = torch.empty_like(t)
    if nblk == 0:
        return out
    _kernels.launch("probe_transpose_chain", "probe_transpose_chain", t.device,
                    t.data_ptr(), out.data_ptr(), nblk, rounds)
    return out


def transpose_chain_bytes(t) -> int:
    """Least traffic of T: the table read once, the output written once."""
    _blocks("transpose_chain", t)
    return 2 * 4 * t.numel()


def transpose_chain_ops(t, rounds: int = ROUNDS) -> int:
    """T's int32 operations: one add per element and round."""
    _blocks("transpose_chain", t)
    return _rounds(rounds) * t.numel()


# ---- X: gather_chain.

def gather_chain_plain(t, i) -> torch.Tensor:
    """Plain version of X: the lane gather, the transpose and the lane
    gather of each block, step by step."""
    nblk = _blocks("gather_chain", t, i)
    _check_range("gather_chain", i, 0, BLOCK)
    t3 = t.view(nblk, BLOCK, BLOCK)
    i3 = i.long().view(nblk, BLOCK, BLOCK)
    a = torch.gather(t3, 2, i3)
    at = a.transpose(1, 2)
    return torch.gather(at, 2, i3).view(t.shape)


def gather_chain(t, i) -> torch.Tensor:
    """X: per 128-row block, with rows local to it,
    ``out[r, c] = t[i[r, c], i[i[r, c], r]]`` for int32 (m, 128) tables and
    i in [0, 128). Kernel on CUDA tensors, plain version on CPU ones."""
    nblk = _blocks("gather_chain", t, i)
    if t.device.type == "cpu":
        return gather_chain_plain(t, i)
    out = torch.empty_like(t)
    if nblk == 0:
        return out
    _launch_chain(t, i, out)
    return out


def _launch_chain(t, i, out) -> None:
    """Launch X on card tensors of whole blocks, each 16-byte aligned."""
    if any(x.data_ptr() % 16 for x in (t, i, out)):
        raise ValueError("gather_chain: the kernel moves 16-byte chunks; t, i and the output "
                         "must be 16-byte aligned")
    _kernels.launch("probe_gather_chain", "probe_gather_chain", t.device,
                    t.data_ptr(), i.data_ptr(), out.data_ptr(), t.shape[0] // BLOCK)


def gather_chain_bytes(t, i) -> int:
    """Least traffic of X: i and the output once, and the distinct sectors
    of t that the chain reads."""
    nblk = _blocks("gather_chain", t, i)
    row = i.view(nblk, BLOCK, BLOCK).to(torch.int64)     # [b, r, c] = i[r, c]
    col = torch.gather(row.transpose(1, 2), 2, row)      # [b, r, c] = i[i[r, c], r]
    base = torch.arange(nblk, device=t.device)[:, None, None] * BLOCK
    flat = (base + row) * BLOCK + col
    return 2 * 4 * i.numel() + measure.distinct_sector_bytes(flat, 4, t.numel())


# ---- S: window_colsum.

def _colsum_check(img, ax, ay) -> None:
    _device("window_colsum", img, ax, ay)
    _expect("window_colsum img", img, (torch.int32,), (2,))
    _expect("window_colsum ax", ax, (torch.int32,), (1,))
    _expect("window_colsum ay", ay, (torch.int32,), (1,))
    if ax.shape != ay.shape:
        raise ValueError(f"window_colsum: ax {tuple(ax.shape)} and ay {tuple(ay.shape)} differ")
    if img.shape[0] < WIN_ROWS or img.shape[1] < WIN_COLS:
        raise ValueError(f"window_colsum: image {tuple(img.shape)} smaller than a "
                         f"{WIN_ROWS} x {WIN_COLS} window")


def _colsum_index(img, ax, ay):
    rows = ay.long()[:, None, None] + torch.arange(WIN_ROWS, device=img.device)[None, :, None]
    cols = ax.long()[:, None, None] + torch.arange(WIN_COLS, device=img.device)[None, None, :]
    return rows, cols


def window_colsum_plain(img, ax, ay) -> torch.Tensor:
    """Plain version of S: the windows by advanced indexing, summed over
    rows in int32."""
    _colsum_check(img, ax, ay)
    _check_range("window_colsum ax", ax, 0, img.shape[1] - WIN_COLS + 1)
    _check_range("window_colsum ay", ay, 0, img.shape[0] - WIN_ROWS + 1)
    rows, cols = _colsum_index(img, ax, ay)
    return img[rows, cols].sum(dim=1, dtype=torch.int32)


def window_colsum(img, ax, ay) -> torch.Tensor:
    """S: for the K = len(ax) windows ``img[ay[k]:ay[k]+96, ax[k]:ax[k]+128]``
    of an int32 image, their column sums, (K, 128) int32. Kernel on CUDA
    tensors, plain version on CPU ones."""
    _colsum_check(img, ax, ay)
    if img.device.type == "cpu":
        return window_colsum_plain(img, ax, ay)
    k = ax.shape[0]
    out = torch.empty((k, WIN_COLS), dtype=torch.int32, device=img.device)
    if k == 0:
        return out
    _kernels.launch("probe_window_colsum", "probe_window_colsum", img.device,
                    img.data_ptr(), ax.data_ptr(), ay.data_ptr(), out.data_ptr(), img.shape[1], k)
    return out


def window_colsum_bytes(img, ax, ay) -> int:
    """Least traffic of S: ax, ay and the sums once, and the distinct
    sectors of img that the windows cover."""
    _colsum_check(img, ax, ay)
    rows, cols = _colsum_index(img, ax, ay)
    k = ax.numel()
    return (2 * 4 * k + 4 * k * WIN_COLS
            + measure.distinct_sector_bytes(rows * img.shape[1] + cols, 4, img.numel()))


def window_colsum_ops(img, ax, ay) -> int:
    """S's int32 operations: 95 adds for each of a window's 128 sums."""
    _colsum_check(img, ax, ay)
    return (WIN_ROWS - 1) * WIN_COLS * ax.numel()
