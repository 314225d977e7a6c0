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
  (``csrc/probe_gather.cu``; ``take_plan`` picks the body that serves a
  call: a staged column band, staged source rows or direct loads).
  ``lane_select_plain`` is its plain version for the one-hot lane select
  of ``probe_mosaic_gather.py``;
* G2 ``point_gather``: ``out[i] = tab[r[i], c[i]]`` (``csrc/probe_gather.cu``;
  ``point_plan`` picks 4 taps a thread with 16-byte moves where r, c and
  the output are aligned, a tap a thread elsewhere);
* C ``relayout``: the transpose or the plain copy of a 2-D int32 table,
  16 bytes a thread where ``relayout_vector`` allows (``csrc/probe_copy.cu``);
* W ``window_copy``: ``out[k*64 + r, c] = img[ay[k] + r, ax[k] + c]``, K
  windows of 64 x 64 int32 (``csrc/probe_copy.cu``; ``window_plan`` picks
  16-byte moves where the image and its rows are 16-byte aligned, word loads
  elsewhere).

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take. A CPU tensor takes the plain version; a CUDA
tensor launches the kernel (counted in ``_kernels.LAUNCHES``) or raises.
The kernels trust their indices to be in range; the plain versions check.
``*_bytes`` give the least device-memory traffic of a call on its inputs
(the bound of ``probes/cases.py``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

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

class TakeGeometry(NamedTuple):
    """A G1 call as csrc/probe_gather.cu takes it: src viewed as (b, s, ws)
    and idx and out as (b, r, w), elements of src_bytes and out_bytes."""
    b: int
    r: int
    w: int
    s: int
    ws: int
    src_bytes: int
    out_bytes: int
    along_rows: bool


def take_geometry(src_shape, idx_shape, axis: int, blocks: int, src_dtype,
                  out_dtype=None) -> TakeGeometry:
    """Validate a G1 call from shapes and dtypes alone."""
    out_dtype = src_dtype if out_dtype is None else out_dtype
    if out_dtype != src_dtype and (src_dtype, out_dtype) != (torch.uint8, torch.int32):
        raise ValueError(f"take_along_axis: {src_dtype} source to {out_dtype} output "
                         "(only uint8 widens, to int32)")
    if axis not in (0, 1):
        raise ValueError(f"take_along_axis: axis must be 0 or 1, got {axis}")
    if blocks < 1 or (blocks > 1 and axis != 0):
        raise ValueError(f"take_along_axis: blocks={blocks} (block-local rows need axis 0)")
    rows, ws = src_shape
    sizes = _ELEMENT[src_dtype], _ELEMENT[out_dtype]
    if len(idx_shape) == 1:
        if axis != 1 or idx_shape[0] != rows:
            raise ValueError("take_along_axis: a 1-D index takes one column of each source row")
        return TakeGeometry(1, rows, 1, rows, ws, *sizes, False)
    r_all, w = idx_shape
    if axis == 1:
        if r_all % rows if rows else r_all:
            raise ValueError(f"take_along_axis: {r_all} index rows are no whole multiple of "
                             f"{rows} source rows")
        return TakeGeometry(1, r_all, w, rows, ws, *sizes, False)
    if w != ws or rows % blocks or r_all % blocks:
        raise ValueError(
            f"take_along_axis: src {tuple(src_shape)} and idx {tuple(idx_shape)} do not "
            f"split into {blocks} blocks of equal width"
        )
    return TakeGeometry(blocks, r_all // blocks, w, rows // blocks, ws, *sizes, True)


def _take_geometry(src, idx, axis: int, blocks: int = 1, out_dtype=None):
    """Validate a G1 call's tensors: (geometry, output dtype)."""
    _device("take_along_axis", src, idx)
    _expect("take_along_axis src", src, tuple(_ELEMENT), (2,))
    _expect("take_along_axis idx", idx, (torch.int32,), (1, 2))
    out_dtype = src.dtype if out_dtype is None else out_dtype
    return take_geometry(src.shape, idx.shape, axis, blocks, src.dtype, out_dtype), out_dtype


# The plan: which of csrc/probe_gather.cu's bodies serves a call, and how
# it is cut. Card limits are sm_90's; the routing thresholds follow the
# measurements on an H100 (PERF.md §6).
SMS = 132                  # an H100 SXM's SMs, the default when no card is asked
SMEM_LIMIT = 232_448       # dynamic shared memory a block may take
SMEM_SM = 233_472          # an SM's shared memory (228 KiB)
SMEM_RESERVED = 1024       # what the card keeps per resident block
THREADS_SM = 2048
BODIES = ("direct", "rows", "lanes")  # D, R and L; their numbers in the C entry
DIRECT_THREADS, ROW_THREADS, LANE_THREADS = 256, 512, 256
BAND = 8                   # R's columns a CTA: one 32-byte sector of each row
ROWS_MIN_SOURCE = 8 << 20     # R: smaller sources stay in L2, where D's sectors cost little
LANES_MIN_OUTPUTS = 8 << 20   # L on a source of its own: D with 16-byte moves ties it below
LANES_MAX_SMEM = 96 << 10     # L: wider source rows go to D
SHARED_ROW_BYTES = 20 << 10   # L on a shared source: staged rows a CTA, then more copies
FULL_CARD_OUTPUTS = 1 << 20   # from here a call fills the card: D moves 16 bytes (a quarter
                              # of the threads left SMs idle below) and a shared source goes to L


@dataclasses.dataclass(frozen=True)
class TakePlan:
    """How G1 serves one call; csrc/probe_gather.cu trusts every field.

    body "direct" (D): one output a thread, or 4 with 16-byte index loads
    and output stores when ``vector``. "rows" (R): a CTA stages ``BAND``
    source columns of one block and serves ``rows`` index rows of them.
    "lanes" (L): a CTA stages ``rows`` source rows and serves ``copies``
    copies of their index rows."""
    body: str
    vector: bool
    rows: int
    copies: int
    smem: int      # dynamic shared memory a block, bytes
    grid: int
    threads: int

    @property
    def label(self) -> str:
        if self.body == "rows":
            cut = f"bands of {BAND} columns, {self.rows} index rows a CTA"
        elif self.body == "lanes":
            cut = f"{self.rows} source rows and {self.copies} copies a CTA"
        else:
            cut = "4 outputs a thread, 16-byte moves" if self.vector else "1 output a thread"
        return (f"{self.body} ({cut}; {self.grid} CTAs x {self.threads} threads, "
                f"{self.smem} B shared)")


def _resident(smem: int, threads: int) -> int:
    """Blocks an SM holds at once, by threads and shared memory."""
    return min(THREADS_SM // threads, SMEM_SM // (smem + SMEM_RESERVED), 32)


def _pitch(s: int) -> int:
    """Words between two staged columns of R (csrc/probe_gather.cu:band_pitch)."""
    return (s + 7) // 8 * 8 + 4


def direct_plan(g: TakeGeometry, vector: bool) -> TakePlan:
    """D: one output a thread, or 4 with 16-byte moves."""
    per = 4 if vector else 1
    return TakePlan("direct", vector, 0, 0, 0, -(-g.b * g.r * g.w // (per * DIRECT_THREADS)),
                    DIRECT_THREADS)


def rows_plan(g: TakeGeometry, sms: int = SMS) -> TakePlan | None:
    """R: bands of BAND columns; a band's index rows split so that the grid
    fills two waves. None where the width is no multiple of BAND or a band
    of S rows does not fit a block (S over 7256)."""
    smem = BAND * _pitch(g.s) * 4
    if g.w % BAND or smem > SMEM_LIMIT:
        return None
    ctas = g.b * (g.w // BAND)
    want = 2 * sms * _resident(smem, ROW_THREADS)
    rows = -(-g.r // min(g.r, -(-want // ctas)))
    return TakePlan("rows", True, rows, 0, smem, ctas * -(-g.r // rows), ROW_THREADS)


def lanes_plan(g: TakeGeometry, sms: int = SMS) -> TakePlan | None:
    """L: on a source of its own, source rows a CTA for two 16-byte index
    chunks a thread; on a source shared by copies of the index rows, up to
    SHARED_ROW_BYTES of source rows a CTA (one chunk a thread at most) and
    its copies split over four CTAs an SM. None where the rows do not fit
    LANES_MAX_SMEM."""
    row_bytes, copies = g.ws * g.src_bytes, g.r // g.s
    per_thread = max(1, LANE_THREADS // (g.w // 4))  # rows that give a thread one chunk
    if copies > 1:
        rows = min(max(1, SHARED_ROW_BYTES // row_bytes), per_thread, g.s)
    else:
        rows = min(2 * per_thread, g.s)
    smem = rows * row_bytes
    if smem > LANES_MAX_SMEM:
        return None
    groups = -(-g.s // rows)
    per = -(-copies // min(copies, -(-4 * sms // groups)))
    return TakePlan("lanes", True, rows, per, smem, groups * -(-copies // per), LANE_THREADS)


def take_plan(g: TakeGeometry, src_mod16: int, idx_mod16: int, out_mod16: int,
              sms: int = SMS) -> TakePlan:
    """The body and cut for a call with these pointer alignments (bytes
    past a multiple of 16): R for large block-local row gathers, L for large
    lane gathers, D for the rest; a 16-byte body only where every pointer it
    moves 16 bytes through is aligned and the widths are whole chunks."""
    chunks = g.w % 4 == 0 and idx_mod16 == 0 and out_mod16 == 0
    n = g.b * g.r * g.w
    if chunks and src_mod16 == 0:
        if (g.along_rows and g.src_bytes == g.out_bytes == 4
                and g.b * g.s * g.ws * 4 >= ROWS_MIN_SOURCE):
            plan = rows_plan(g, sms=sms)
            if plan:
                return plan
        if (not g.along_rows and g.ws * g.src_bytes % 16 == 0
                and n >= (FULL_CARD_OUTPUTS if g.r > g.s else LANES_MIN_OUTPUTS)):
            plan = lanes_plan(g, sms=sms)
            if plan:
                return plan
    return direct_plan(g, chunks and n >= FULL_CARD_OUTPUTS)


def check_take_plan(plan: TakePlan, g: TakeGeometry, src_mod16: int, idx_mod16: int,
                    out_mod16: int) -> None:
    """Raise ValueError for a plan that csrc/probe_gather.cu cannot take on
    this call: the kernels trust every field."""
    def bad(why):
        raise ValueError(f"take_along_axis: {plan} cannot serve {g}: {why}")

    if plan.body not in BODIES:
        bad("unknown body")
    if not (0 < plan.threads <= 1024 and 0 < plan.grid <= _I32_MAX):
        bad("grid or block out of range")
    if not 0 <= plan.smem <= SMEM_LIMIT:
        bad(f"shared memory over the {SMEM_LIMIT} B a block may take")
    chunks = g.w % 4 == 0 and idx_mod16 == 0 and out_mod16 == 0
    n = g.b * g.r * g.w
    if plan.body == "direct":
        if plan.vector and not chunks:
            bad("16-byte index and output moves need widths of whole chunks, aligned")
        if plan.grid * plan.threads * (4 if plan.vector else 1) < n:
            bad("the grid does not cover the output")
        return
    if not (chunks and src_mod16 == 0 and plan.vector):
        bad("a staging body moves 16-byte chunks of every array")
    if plan.rows < 1:
        bad("no rows a CTA")
    if plan.body == "rows":
        if not (g.along_rows and g.src_bytes == g.out_bytes == 4):
            bad("R gathers 4-byte rows")
        if g.w % BAND:
            bad(f"R's bands of {BAND} columns do not divide the width")
        if plan.smem < BAND * _pitch(g.s) * 4:
            bad("R's band does not fit its shared memory")
        if plan.grid != g.b * (g.w // BAND) * -(-g.r // plan.rows):
            bad("R's grid is blocks x bands x splits")
        return
    if g.along_rows or g.ws * g.src_bytes % 16:
        bad("L gathers lanes from rows of whole 16-byte chunks")
    if plan.copies < 1 or plan.smem < min(plan.rows, g.s) * g.ws * g.src_bytes:
        bad("L's rows do not fit its shared memory")
    if plan.grid != -(-g.s // plan.rows) * -(-(g.r // g.s) // plan.copies):
        bad("L's grid is row groups x copy splits")


def _launch_take(src, idx, out, g: TakeGeometry, plan: TakePlan) -> None:
    """Launch G1 on card tensors with this plan (checked first)."""
    mods = src.data_ptr() % 16, idx.data_ptr() % 16, out.data_ptr() % 16
    check_take_plan(plan, g, *mods)
    _kernels.launch(
        "probe_take", "probe_take", src.device,
        src.data_ptr(), idx.data_ptr(), out.data_ptr(), g.src_bytes, g.out_bytes,
        int(g.along_rows), g.r, g.w, g.s, g.ws, out.numel(), BODIES.index(plan.body),
        int(plan.vector), plan.rows, plan.copies, plan.smem, plan.grid, plan.threads,
    )


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def take_along_axis_plain(src, idx, axis: int, blocks: int = 1, out_dtype=None) -> torch.Tensor:
    """Plain version of G1 (torch.gather)."""
    g, out_dtype = _take_geometry(src, idx, axis, blocks, out_dtype)
    b, r, w, s, ws = g.b, g.r, g.w, g.s, g.ws
    _check_range("take_along_axis", idx, 0, s if axis == 0 else ws)
    if idx.dim() == 1:
        out = torch.gather(src, 1, idx.long()[:, None])[:, 0]
    elif axis == 1:
        copies = r // s if s else 1
        out = torch.gather(src.expand(copies, s, ws), 2, idx.long().view(copies, s, w))
    else:
        out = torch.gather(src.view(b, s, w), 1, idx.long().view(b, r, w))
    return out.view(idx.shape).to(out_dtype)


def take_plan_for(src, idx, axis: int, blocks: int = 1, out_dtype=None) -> TakePlan:
    """The plan ``take_along_axis`` takes for these card tensors (its
    output, a fresh allocation, is aligned)."""
    g, _ = _take_geometry(src, idx, axis, blocks, out_dtype)
    return take_plan(g, src.data_ptr() % 16, idx.data_ptr() % 16, 0, _sms(src.device))


def take_along_axis(src, idx, axis: int, blocks: int = 1, out_dtype=None) -> torch.Tensor:
    """G1: ``take_along_axis(src, idx, axis)``; on axis 0 with ``blocks`` > 1,
    index row block i gathers from source row block i; on axis 1, index row
    r gathers from source row ``r % rows``. The output has idx's shape and
    ``out_dtype`` (default src's; a uint8 source may widen to int32). Kernel
    on a CUDA tensor, served by the body ``take_plan`` picks; plain version
    on a CPU one."""
    g, out_dtype = _take_geometry(src, idx, axis, blocks, out_dtype)
    if src.device.type == "cpu":
        return take_along_axis_plain(src, idx, axis, blocks, out_dtype)
    out = torch.empty(idx.shape, dtype=out_dtype, device=src.device)
    if out.numel() == 0:
        return out
    plan = take_plan(g, src.data_ptr() % 16, idx.data_ptr() % 16, out.data_ptr() % 16,
                     _sms(src.device))
    _launch_take(src, idx, out, g, plan)
    return out


def take_along_axis_bytes(src, idx, axis: int, blocks: int = 1, out_dtype=None) -> int:
    """Least traffic of G1: the index and the output once, and the distinct
    sectors of src that the indices touch."""
    g, out_dtype = _take_geometry(src, idx, axis, blocks, out_dtype)
    b, r, w, s, ws = g.b, g.r, g.w, g.s, g.ws
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


# G2's plan: which body of csrc/probe_gather.cu serves a call, and its grid.
POINT_THREADS, POINT_TAPS = 512, 4   # V: a run of 2048 taps a CTA, 4 a thread
SCALAR_THREADS = 256                 # S: a tap a thread


class PointPlan(NamedTuple):
    """How G2 serves a call of n taps; csrc/probe_gather.cu trusts it.
    vector: V (16-byte moves of r, c and out, 4 taps a thread), else S."""
    vector: bool
    grid: int

    @property
    def label(self) -> str:
        body = (f"V, {POINT_TAPS} taps a thread, {POINT_THREADS * POINT_TAPS} a CTA"
                if self.vector else "S, a tap a thread")
        threads = POINT_THREADS if self.vector else SCALAR_THREADS
        return f"{body}; {self.grid} CTAs x {threads} threads"


def point_plan(n: int, r_mod16: int, c_mod16: int, out_mod16: int) -> PointPlan:
    """V where r, c and out all start on a 16-byte boundary (bytes past a
    multiple of 16), its grid over the n // 4 whole quads of taps (at least
    one CTA, whose first threads take the n % 4 left); S elsewhere."""
    if r_mod16 == c_mod16 == out_mod16 == 0:
        return PointPlan(True, max(1, -(-(n // POINT_TAPS) // POINT_THREADS)))
    return PointPlan(False, -(-n // SCALAR_THREADS))


def check_point_plan(plan: PointPlan, n: int, r_mod16: int, c_mod16: int,
                     out_mod16: int) -> None:
    """Raise ValueError for a plan csrc/probe_gather.cu cannot take on this
    call: the kernel trusts it."""
    if plan.vector and (r_mod16 or c_mod16 or out_mod16):
        raise ValueError(f"point_gather: {plan} moves 16-byte chunks of r, c and out, which "
                         "must be 16-byte aligned")
    # V: a thread a quad of taps; CTA 0 also takes the last n % 4.
    units, per_cta = (n // POINT_TAPS, POINT_THREADS) if plan.vector else (n, SCALAR_THREADS)
    if not 0 < plan.grid <= _I32_MAX or plan.grid * per_cta < units:
        raise ValueError(f"point_gather: {plan} does not cover {n} taps")


def point_plan_for(tab, r, c) -> PointPlan:
    """The plan ``point_gather`` takes for these card tensors (its output, a
    fresh allocation, is aligned)."""
    _point_check(tab, r, c)
    return point_plan(r.numel(), r.data_ptr() % 16, c.data_ptr() % 16, 0)


def _launch_point(tab, r, c, out, plan: PointPlan) -> None:
    """Launch G2 on card tensors with this plan (checked first)."""
    check_point_plan(plan, out.numel(), r.data_ptr() % 16, c.data_ptr() % 16,
                     out.data_ptr() % 16)
    _kernels.launch(
        "probe_point_gather", "probe_point_gather", tab.device,
        tab.data_ptr(), r.data_ptr(), c.data_ptr(), out.data_ptr(), tab.shape[1], out.numel(),
        int(plan.vector), plan.grid,
    )


def point_gather(tab, r, c) -> torch.Tensor:
    """G2: ``out[i] = tab[r[i], c[i]]`` for an int32 (rows, cols) table.
    Kernel on CUDA tensors, served by the body ``point_plan`` picks; plain
    version on CPU ones."""
    _point_check(tab, r, c)
    if tab.device.type == "cpu":
        return point_gather_plain(tab, r, c)
    out = torch.empty(r.shape, dtype=torch.int32, device=tab.device)
    if out.numel() == 0:
        return out
    _launch_point(tab, r, c, out, point_plan(out.numel(), r.data_ptr() % 16,
                                             c.data_ptr() % 16, out.data_ptr() % 16))
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


def relayout_vector(rows: int, cols: int, transpose: bool, src_mod16: int,
                    out_mod16: int) -> bool:
    """C's plan: 16-byte moves only where both bases are 16-byte aligned
    (bytes past a multiple of 16) and, for the transpose, every source and
    output row is whole 16-byte chunks."""
    aligned = src_mod16 == 0 and out_mod16 == 0
    return aligned and (not transpose or (rows % 4 == 0 and cols % 4 == 0))


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
    vector = relayout_vector(rows, cols, transpose, src.data_ptr() % 16, out.data_ptr() % 16)
    _kernels.launch("probe_relayout", "probe_relayout", src.device,
                    src.data_ptr(), out.data_ptr(), rows, cols, int(transpose), int(vector))
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


# W's plan: which body of csrc/probe_copy.cu serves a call.
WINDOW_SPLIT = 4                     # the 16-byte body: CTAs a window, 16 rows each


class WindowPlan(NamedTuple):
    """How W serves a call; csrc/probe_copy.cu trusts it. vector: aligned
    16-byte loads of the image rows and 16-byte stores, WINDOW_SPLIT CTAs a
    window; else word loads, a CTA a window."""
    vector: bool

    @property
    def label(self) -> str:
        if self.vector:
            return (f"16-byte moves, {WINDOW_SPLIT} CTAs of {WINDOW // WINDOW_SPLIT * 16} "
                    "threads a window")
        return "word loads, a CTA of 256 threads a window"


def window_plan(width: int, img_mod16: int, out_mod16: int) -> WindowPlan:
    """16-byte moves where the image's base and the output start on a
    16-byte boundary (bytes past a multiple of 16) and every image row is
    whole 16-byte chunks (width a multiple of 4); word loads elsewhere."""
    return WindowPlan(img_mod16 == 0 and out_mod16 == 0 and width % 4 == 0)


def check_window_plan(plan: WindowPlan, width: int, img_mod16: int, out_mod16: int) -> None:
    """Raise ValueError for a plan csrc/probe_copy.cu cannot take on this
    image: the kernel trusts it."""
    if plan.vector and not window_plan(width, img_mod16, out_mod16).vector:
        raise ValueError(f"window_copy: {plan} moves 16-byte chunks; the image and output "
                         "must be 16-byte aligned and the width a multiple of 4")


def window_plan_for(img, ax, ay) -> WindowPlan:
    """The plan ``window_copy`` takes for these card tensors (its output, a
    fresh allocation, is aligned)."""
    _window_check(img, ax, ay)
    return window_plan(img.shape[1], img.data_ptr() % 16, 0)


def _launch_window(img, ax, ay, out, plan: WindowPlan) -> None:
    """Launch W on card tensors with this plan (checked first)."""
    check_window_plan(plan, img.shape[1], img.data_ptr() % 16, out.data_ptr() % 16)
    _kernels.launch("probe_window_copy", "probe_window_copy", img.device,
                    img.data_ptr(), ax.data_ptr(), ay.data_ptr(), out.data_ptr(), img.shape[1],
                    ax.shape[0], int(plan.vector))


def window_copy(img, ax, ay) -> torch.Tensor:
    """W: the K = len(ax) windows ``img[ay[k]:ay[k]+64, ax[k]:ax[k]+64]`` of
    an int32 image stacked into (K*64, 64). Kernel on CUDA tensors, served by
    the body ``window_plan`` picks; plain version on CPU ones."""
    _window_check(img, ax, ay)
    if img.device.type == "cpu":
        return window_copy_plain(img, ax, ay)
    k = ax.shape[0]
    out = torch.empty((k * WINDOW, WINDOW), dtype=torch.int32, device=img.device)
    if k == 0:
        return out
    _launch_window(img, ax, ay, out,
                   window_plan(img.shape[1], img.data_ptr() % 16, out.data_ptr() % 16))
    return out


def window_copy_bytes(img, ax, ay) -> int:
    """Least traffic of W: ax, ay and the output once, and the distinct
    sectors of img that the windows cover."""
    _window_check(img, ax, ay)
    rows, cols = _window_index(img, ax, ay)
    return (2 * 4 * ax.numel() + 4 * ax.numel() * WINDOW * WINDOW
            + measure.distinct_sector_bytes(rows * img.shape[1] + cols, 4, img.numel()))
