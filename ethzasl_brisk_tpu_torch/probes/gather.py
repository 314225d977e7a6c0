"""The gather probes' gathers and copies on Hopper, each beside its plain version.

The TPU probes under ``tools/`` time per-keypoint window copies and
gathers into those windows, the building blocks of a describe sampler that
stages each keypoint's window in fast memory. These four functions serve
the ``pallas_call`` sites of P1 and P3 and the gathers of P2
(``probes/cases.py`` maps each site; ``probes/mosaic.py`` holds P2's other
kernels):

* G1 ``take_along_axis``: numpy's ``take_along_axis`` on axis 0 or 1 of a
  2-D int32, float32 or uint8 table, any width; on axis 0 optionally
  block-local (``blocks`` equal blocks of source rows, one per block of
  index rows); on axis 1 also with a 1-D index, one column per row, or with
  index rows a whole multiple of the source rows (each block of them reads
  the same source); a uint8 source may widen to an int32 output
  (``csrc/probe_gather.cu``). ``lane_select_plain`` is its plain version
  for the one-hot lane select of ``probe_mosaic_gather.py``;
* G2 ``point_gather``: ``out[i] = tab[r[i], c[i]]`` (``csrc/probe_gather.cu``);
* C ``relayout``: the transpose or the plain copy of a 2-D int32 table,
  through shared memory (``csrc/probe_copy.cu``);
* W ``window_copy``: ``out[k*64 + r, c] = img[ay[k] + r, ax[k] + c]``, K
  windows of 64 x 64 int32 (``csrc/probe_copy.cu``).

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take. A CPU tensor takes the plain version; a CUDA
tensor launches the kernel (counted in ``_kernels.LAUNCHES``) or raises.
The kernels trust their indices to be in range; the plain versions check.
``*_bytes`` give the least device-memory traffic of a call on its inputs
(the bound of ``probes/cases.py``).
"""
from __future__ import annotations

import torch

from ethzasl_brisk_tpu_torch import _kernels, measure

WINDOW = 64
_ELEMENT = {torch.int32: 4, torch.float32: 4, torch.uint8: 1}
_I32_MAX = 2**31 - 1


def _device(name: str, *tensors: torch.Tensor) -> torch.device:
    """The one device all inputs lie on: the CPU or a card."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: inputs on {[str(t.device) for t in tensors]}, expected one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: runs on cpu or cuda tensors, got {dev}")
    return dev


def _expect(name: str, t: torch.Tensor, dtypes, dims) -> None:
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: expected dtype in {dtypes}, got {t.dtype}")
    if t.dim() not in dims:
        raise ValueError(f"{name}: expected {dims}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.numel() > _I32_MAX:
        raise ValueError(f"{name}: {t.numel()} elements do not fit int32 indexing")


def _check_range(name: str, idx: torch.Tensor, lo: int, hi: int) -> None:
    """Plain versions only: every index in [lo, hi)."""
    if idx.numel() and (int(idx.min()) < lo or int(idx.max()) >= hi):
        raise ValueError(f"{name}: indices outside [{lo}, {hi})")


# ---- G1: take_along_axis.

def _take_geometry(src, idx, axis: int, blocks: int, out_dtype=None):
    """Validate a G1 call: (B, R, W, S, Ws, out dtype) with src viewed as
    (B, S, Ws) and idx as (B, R, W), as csrc/probe_gather.cu takes them."""
    _device("take_along_axis", src, idx)
    _expect("take_along_axis src", src, tuple(_ELEMENT), (2,))
    _expect("take_along_axis idx", idx, (torch.int32,), (1, 2))
    out_dtype = src.dtype if out_dtype is None else out_dtype
    if out_dtype != src.dtype and (src.dtype, out_dtype) != (torch.uint8, torch.int32):
        raise ValueError(f"take_along_axis: {src.dtype} source to {out_dtype} output "
                         "(only uint8 widens, to int32)")
    if axis not in (0, 1):
        raise ValueError(f"take_along_axis: axis must be 0 or 1, got {axis}")
    if blocks < 1 or (blocks > 1 and axis != 0):
        raise ValueError(f"take_along_axis: blocks={blocks} (block-local rows need axis 0)")
    rows, ws = src.shape
    if idx.dim() == 1:
        if axis != 1 or idx.shape[0] != rows:
            raise ValueError("take_along_axis: a 1-D index takes one column of each source row")
        return 1, rows, 1, rows, ws, out_dtype
    r_all, w = idx.shape
    if axis == 1:
        if r_all % rows if rows else r_all:
            raise ValueError(f"take_along_axis: {r_all} index rows are no whole multiple of "
                             f"{rows} source rows")
        return 1, r_all, w, rows, ws, out_dtype
    if w != ws or rows % blocks or r_all % blocks:
        raise ValueError(
            f"take_along_axis: src {tuple(src.shape)} and idx {tuple(idx.shape)} do not "
            f"split into {blocks} blocks of equal width"
        )
    return blocks, r_all // blocks, w, rows // blocks, ws, out_dtype


def take_along_axis_plain(src, idx, axis: int, blocks: int = 1, out_dtype=None) -> torch.Tensor:
    """Plain version of G1 (torch.gather)."""
    b, r, w, s, ws, out_dtype = _take_geometry(src, idx, axis, blocks, out_dtype)
    _check_range("take_along_axis", idx, 0, s if axis == 0 else ws)
    if idx.dim() == 1:
        out = torch.gather(src, 1, idx.long()[:, None])[:, 0]
    elif axis == 1:
        copies = r // s if s else 1
        out = torch.gather(src.expand(copies, s, ws), 2, idx.long().view(copies, s, w))
    else:
        out = torch.gather(src.view(b, s, w), 1, idx.long().view(b, r, w))
    return out.view(idx.shape).to(out_dtype)


def take_along_axis(src, idx, axis: int, blocks: int = 1, out_dtype=None) -> torch.Tensor:
    """G1: ``take_along_axis(src, idx, axis)``; on axis 0 with ``blocks`` > 1,
    index row block i gathers from source row block i; on axis 1, index row
    r gathers from source row ``r % rows``. The output has idx's shape and
    ``out_dtype`` (default src's; a uint8 source may widen to int32). Kernel
    on a CUDA tensor, plain version on a CPU one."""
    b, r, w, s, ws, out_dtype = _take_geometry(src, idx, axis, blocks, out_dtype)
    if src.device.type == "cpu":
        return take_along_axis_plain(src, idx, axis, blocks, out_dtype)
    out = torch.empty(idx.shape, dtype=out_dtype, device=src.device)
    if out.numel() == 0:
        return out
    _kernels.launch(
        "probe_take", "probe_take", src.device,
        src.data_ptr(), idx.data_ptr(), out.data_ptr(), _ELEMENT[src.dtype],
        _ELEMENT[out_dtype], int(axis == 0), r, w, s, ws, out.numel(),
    )
    return out


def take_along_axis_bytes(src, idx, axis: int, blocks: int = 1, out_dtype=None) -> int:
    """Least traffic of G1: the index and the output once, and the distinct
    sectors of src that the indices touch."""
    b, r, w, s, ws, out_dtype = _take_geometry(src, idx, axis, blocks, out_dtype)
    dev = src.device
    cols = torch.arange(w, device=dev)
    rows = torch.arange(b * r, device=dev)[:, None]
    i = idx.view(b * r, w).to(torch.int64)
    if axis == 0:
        flat = ((rows // r) * s + i) * ws + cols
    else:
        flat = (rows % max(s, 1)) * ws + i
    element = _ELEMENT[src.dtype]
    return (idx.numel() * 4 + idx.numel() * _ELEMENT[out_dtype]
            + measure.distinct_sector_bytes(flat, element, src.numel()))


def lane_select_plain(src, idx, axis: int = 1) -> torch.Tensor:
    """Plain version of G1 as ``probe_mosaic_gather.py``'s one-hot lane
    select computes it: ``out[r, 0] = sum_j [j == idx[r, 0]] * src[r, j]`` in
    float32, a product with a one-hot mask and a lane sum. Equal bit for bit
    to ``take_along_axis(src, idx[:, :1], 1)`` on finite tables without -0.0."""
    _take_geometry(src, idx, axis, 1)
    if axis != 1 or src.dtype != torch.float32 or tuple(idx.shape) != (src.shape[0], 1):
        raise ValueError("lane_select: a float32 source and one index column per row, axis 1")
    _check_range("lane_select", idx, 0, src.shape[1])
    lanes = torch.arange(src.shape[1], dtype=torch.int32, device=src.device)
    one_hot = (idx == lanes).to(torch.float32)
    return (one_hot * src).sum(dim=1, keepdim=True)


# ---- G2: point_gather.

def _point_check(tab, r, c) -> None:
    _device("point_gather", tab, r, c)
    _expect("point_gather tab", tab, (torch.int32,), (2,))
    _expect("point_gather r", r, (torch.int32,), (1,))
    _expect("point_gather c", c, (torch.int32,), (1,))
    if r.shape != c.shape:
        raise ValueError(f"point_gather: r {tuple(r.shape)} and c {tuple(c.shape)} differ")


def point_gather_plain(tab, r, c) -> torch.Tensor:
    """Plain version of G2 (advanced indexing)."""
    _point_check(tab, r, c)
    _check_range("point_gather r", r, 0, tab.shape[0])
    _check_range("point_gather c", c, 0, tab.shape[1])
    return tab[r.long(), c.long()]


def point_gather(tab, r, c) -> torch.Tensor:
    """G2: ``out[i] = tab[r[i], c[i]]`` for an int32 (rows, cols) table.
    Kernel on CUDA tensors, plain version on CPU ones."""
    _point_check(tab, r, c)
    if tab.device.type == "cpu":
        return point_gather_plain(tab, r, c)
    out = torch.empty(r.shape, dtype=torch.int32, device=tab.device)
    if out.numel() == 0:
        return out
    _kernels.launch(
        "probe_point_gather", "probe_point_gather", tab.device,
        tab.data_ptr(), r.data_ptr(), c.data_ptr(), out.data_ptr(), tab.shape[1], out.numel(),
    )
    return out


def point_gather_bytes(tab, r, c) -> int:
    """Least traffic of G2: r, c and the output once, and the distinct
    sectors of tab that the points touch."""
    _point_check(tab, r, c)
    flat = r.to(torch.int64) * tab.shape[1] + c.to(torch.int64)
    return 3 * 4 * r.numel() + measure.distinct_sector_bytes(flat, 4, tab.numel())


# ---- C: relayout.

def _relayout_check(src) -> None:
    _device("relayout", src)
    _expect("relayout src", src, (torch.int32,), (2,))


def relayout_plain(src, transpose: bool) -> torch.Tensor:
    """Plain version of C: ``src.T.contiguous()`` or ``src.clone()``."""
    _relayout_check(src)
    return src.T.contiguous() if transpose else src.clone()


def relayout(src, transpose: bool) -> torch.Tensor:
    """C: an int32 (rows, cols) table as its contiguous (cols, rows)
    transpose, or copied as it is. Kernel on a CUDA tensor, plain version on
    a CPU one."""
    _relayout_check(src)
    if src.device.type == "cpu":
        return relayout_plain(src, transpose)
    rows, cols = src.shape
    out = torch.empty((cols, rows) if transpose else (rows, cols), dtype=torch.int32,
                      device=src.device)
    if out.numel() == 0:
        return out
    _kernels.launch("probe_relayout", "probe_relayout", src.device,
                    src.data_ptr(), out.data_ptr(), rows, cols, int(transpose))
    return out


def relayout_bytes(src, transpose: bool) -> int:
    """Least traffic of C: src read once, the output written once."""
    _relayout_check(src)
    return 2 * 4 * src.numel()


# ---- W: window_copy.

def _window_check(img, ax, ay) -> None:
    _device("window_copy", img, ax, ay)
    _expect("window_copy img", img, (torch.int32,), (2,))
    _expect("window_copy ax", ax, (torch.int32,), (1,))
    _expect("window_copy ay", ay, (torch.int32,), (1,))
    if ax.shape != ay.shape:
        raise ValueError(f"window_copy: ax {tuple(ax.shape)} and ay {tuple(ay.shape)} differ")
    if img.shape[0] < WINDOW or img.shape[1] < WINDOW:
        raise ValueError(f"window_copy: image {tuple(img.shape)} smaller than a window")


def _window_index(img, ax, ay):
    r = torch.arange(WINDOW, device=img.device)
    rows = ay.long()[:, None, None] + r[None, :, None]
    cols = ax.long()[:, None, None] + r[None, None, :]
    return rows, cols


def window_copy_plain(img, ax, ay) -> torch.Tensor:
    """Plain version of W (advanced indexing)."""
    _window_check(img, ax, ay)
    _check_range("window_copy ax", ax, 0, img.shape[1] - WINDOW + 1)
    _check_range("window_copy ay", ay, 0, img.shape[0] - WINDOW + 1)
    rows, cols = _window_index(img, ax, ay)
    return img[rows, cols].reshape(-1, WINDOW)


def window_copy(img, ax, ay) -> torch.Tensor:
    """W: the K = len(ax) windows ``img[ay[k]:ay[k]+64, ax[k]:ax[k]+64]`` of
    an int32 image stacked into (K*64, 64). Kernel on CUDA tensors, plain
    version on CPU ones."""
    _window_check(img, ax, ay)
    if img.device.type == "cpu":
        return window_copy_plain(img, ax, ay)
    k = ax.shape[0]
    out = torch.empty((k * WINDOW, WINDOW), dtype=torch.int32, device=img.device)
    if k == 0:
        return out
    _kernels.launch("probe_window_copy", "probe_window_copy", img.device,
                    img.data_ptr(), ax.data_ptr(), ay.data_ptr(), out.data_ptr(), img.shape[1], k)
    return out


def window_copy_bytes(img, ax, ay) -> int:
    """Least traffic of W: ax, ay and the output once, and the distinct
    sectors of img that the windows cover."""
    _window_check(img, ax, ay)
    rows, cols = _window_index(img, ax, ay)
    return (2 * 4 * ax.numel() + 4 * ax.numel() * WINDOW * WINDOW
            + measure.distinct_sector_bytes(rows * img.shape[1] + cols, 4, img.numel()))
