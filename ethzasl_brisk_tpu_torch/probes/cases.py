"""The 26 ``pallas_call`` sites of the TPU gather probes P1, P3 and P2, and
the run that holds each site's kernel against its plain version on the card.

One ``Case`` per call of a site: sites 1-16 (P1 and P3) run once each but
site 11, ``lane_scaled``, which runs at the probe's two scales; sites 17-26
(P2, ``tools/probes/probe_mosaic_gather{,2,3,4}.py``) run 22 calls, site
17's ``probe`` seven times, site 18's five, site 25's three. A case holds the
probe's function name and the file:line of its ``pallas_call``, an input
maker at the probe's full shapes or at a small test shape, drawn from
``np.random.default_rng`` with the probe's value and index distributions,
and the kernel that serves it (``probes/gather.py``, ``probes/mosaic.py``).
All indices are int32 and in range, as in every probe.

Traps kept in view here and in the tests:

* site 2 (``pallas_rows``) runs a grid of ``rows // 2048`` blocks, so the TPU
  kernel never writes its last ``rows % 2048`` output rows; the port writes
  them all and the comparison with the JAX probe covers the written rows;
* site 8 (``sub_gather``) does not trace in JAX (``take_along_axis`` on the
  3-D blocks raises ``ValueError: Incompatible shapes for broadcasting``);
  the port serves its intended function, site 9's;
* sites 5, 8, 9 and 13 gather block-local rows, site 2 global rows;
* site 6's source and output are uint8; site 24 widens a uint8 source to
  an int32 output;
* site 17's last call is a one-hot lane select in float32 (a product and
  a lane sum), served by G1 on index column 0: equal bit for bit on the
  probe's tables, integers in [0, 1000);
* site 19's 64 grid steps all read the same (256, 2432) source block;
* site 21's eight transposes and adds equal ``t + 8``.

``run_all`` is what ``python -m ethzasl_brisk_tpu_torch.probes`` and the
``[probes]`` phase of ``chip_smoke.py`` run: each case once with the launch
counters set to 0 just before and read just after, bitwise against the plain
version, then timed against the plain version and the one PyTorch call that
computes the same function, beside its bound. Each kernel and library call
is timed twice: by CUDA events around the call, which include its host work
(the wrapper's checks, the ctypes call), and by ``torch.profiler`` as the
kernels' own time on the card. Nothing is caught: a mismatch or a launch
error ends the run.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ethzasl_brisk_tpu_torch import _kernels, measure
from ethzasl_brisk_tpu_torch.probes import gather, mosaic

P1 = "tools/bench_pallas_gather.py"
SUBLANE = "tools/probes/probe_sublane_gather.py"
FORMULATIONS = "tools/probes/probe_gather_formulations.py"
BLOCKS = "tools/probes/probe_sampler_blocks.py"
MOSAIC = "tools/probes/probe_mosaic_gather.py"
MOSAIC2 = "tools/probes/probe_mosaic_gather2.py"
MOSAIC3 = "tools/probes/probe_mosaic_gather3.py"
MOSAIC4 = "tools/probes/probe_mosaic_gather4.py"

# P1's geometry (bench_pallas_gather.py:54-71): an (h, w) int32 table padded
# into (rows_t, 128), n taps in clusters of ``cluster`` within +-spread
# pixels of each centre, cut to whole grid blocks of ``blk`` taps.
P1_GEOMETRY = {
    True: dict(h=481, w=641, rows_t=2432, n=2_000_000, cluster=2048, spread=64, blk=2048),
    False: dict(h=41, w=61, rows_t=24, n=2500, cluster=64, spread=8, blk=16),
}
# Sizes of the P3 probes at full scale (True) and at the test's small scale.
SUBLANE_SMALL = {True: dict(s=512, j=256), False: dict(s=64, j=32)}
SUBLANE_BLOCKS = {True: dict(nblk=128, s=4096, j=4752), False: dict(nblk=3, s=64, j=72)}
# Rows of each lane-gather table: gather_big's m, lane_scaled's nblk x 8192.
LANE_ROWS = {10: {True: 131072, False: 512}, 8: {True: 8 * 8192, False: 2 * 256},
             32: {True: 32 * 8192, False: 4 * 256}}
# probe_sampler_blocks' 8192-row blocks (lane_scaled, f_sub, f_sub_big) and
# f_sub_big's block count.
BLOCK_ROWS = {True: 8192, False: 256}
SQUARE_BLOCKS = {1: {True: 1, False: 1}, 32: {True: 32, False: 3}}
PATCHES = {True: (128, 64, 64), False: (16, 8, 8)}
DMA_IMAGE = {True: dict(h=488, w=768, k=128), False: dict(h=72, w=100, k=16)}


def p1_taps(rng: np.random.Generator, full: bool):
    """P1's padded table (rows_t, 128) and the clustered taps' row and lane
    indices into it, n_round of each."""
    g = P1_GEOMETRY[full]
    h, w = g["h"], g["w"]
    table = rng.integers(0, 2**20, (h, w), dtype=np.int32)
    tabp = np.zeros((g["rows_t"] * 128,), np.int32)
    tabp[: h * w] = table.reshape(-1)
    n_c = max(g["n"] // g["cluster"], 1)
    cy = rng.integers(g["spread"], h - g["spread"], n_c)
    cx = rng.integers(g["spread"], w - g["spread"], n_c)
    off = rng.integers(-g["spread"], g["spread"], (n_c, g["cluster"], 2))
    ys = np.clip(cy[:, None] + off[..., 0], 0, h - 1).reshape(-1)[: g["n"]]
    xs = np.clip(cx[:, None] + off[..., 1], 0, w - 1).reshape(-1)[: g["n"]]
    flat = (ys * w + xs).astype(np.int32)
    n_round = (g["n"] // g["blk"]) * g["blk"]
    return tabp.reshape(g["rows_t"], 128), flat[:n_round] // 128, flat[:n_round] % 128


def _ints(rng, shape, hi=1 << 22, dtype=np.int32):
    return rng.integers(0, hi, shape, dtype=dtype)


def _site1(rng, full):
    tab, r, c = p1_taps(rng, full)
    return dict(tab=tab, r=r, c=c)


def _site2(rng, full):
    tab, r, _ = p1_taps(rng, full)
    return dict(tab=tab, idx=np.ascontiguousarray(np.tile(r[: r.shape[0] // 128, None], (1, 128))))


def _site3(rng, full):
    _, _, c = p1_taps(rng, full)
    return dict(src=_ints(rng, (c.shape[0], 128), 2**20), idx=c)


def _sublane(dtype, hi):
    def make(rng, full):
        g = SUBLANE_SMALL[full]
        return dict(src=_ints(rng, (g["s"], 128), hi, dtype), idx=_ints(rng, (g["j"], 128), g["s"]))
    return make


def _sublane_blocks(rng, full):
    g = SUBLANE_BLOCKS[full]
    return dict(src=_ints(rng, (g["nblk"] * g["s"], 128)),
                idx=_ints(rng, (g["nblk"] * g["j"], 128), g["s"]), blocks=g["nblk"])


def _patches(rng, full):
    return dict(pat=_ints(rng, PATCHES[full]))


def _lane(rows, hi):
    def make(rng, full):
        m = rows[full]
        return dict(src=_ints(rng, (m, 128), hi), idx=_ints(rng, (m, 128), 128))
    return make


def _square(blocks):
    def make(rng, full):
        s, nblk = BLOCK_ROWS[full], blocks[full]
        return dict(src=_ints(rng, (nblk * s, 64)), idx=_ints(rng, (nblk * s, 64), s),
                    blocks=nblk)
    return make


def _windows(rng, full):
    g = DMA_IMAGE[full]
    return dict(img=_ints(rng, (g["h"], g["w"])),
                ax=_ints(rng, (g["k"],), g["w"] - 64), ay=_ints(rng, (g["k"],), g["h"] - 64))


def _scales(full, small):
    return {True: full, False: small}


# P2's shapes at full scale (the probes' own) and at the test's small scale.
# probe_mosaic_gather.py: a (256, 128) table, row indices (8, 128) or of
# the table's shape, lane indices of the table's shape or (256, 1).
TABLE17 = _scales((256, 128), (32, 128))
COL17 = _scales((256, 1), (32, 1))
SHORT17 = _scales((8, 128), (8, 128))
# probe_mosaic_gather2.py: lane gathers from sources up to 65536 wide, and
# wide's 64 grid steps of 256 index rows over one (256, 2432) source.
LANE18 = _scales((256, 128), (16, 128))
WIDE19 = _scales((256, 2432), (16, 608))
WIDE19_IDX = _scales((64 * 256, 128), (4 * 16, 128))
# probe_mosaic_gather3.py's (16384, 128) tables, probe_mosaic_gather4.py's
# three sizes, and dma_patches' images with 512 windows of 96 x 128.
TABLE3 = _scales((16384, 128), (384, 128))
SCALED25 = [_scales((m, 128), (small, 128))
            for m, small in ((16384, 256), (131072, 512), (524288, 1024))]
IMAGE23 = _scales((481, 768), (120, 200))
IMAGE26 = _scales((488, 768), (120, 200))
WINDOWS = _scales(512, 16)


def _gather(src, idx, axis, dtype=np.int32, hi=1000):
    """A take_along_axis probe's table in [0, hi) and its indices along
    ``axis``; ``src`` and ``idx`` give the shapes per scale."""
    def make(rng, full):
        shape = src[full]
        tab = _ints(rng, shape, hi, np.uint8 if dtype == np.uint8 else np.int32)
        return dict(src=tab.astype(dtype, copy=False), idx=_ints(rng, idx[full], shape[axis]))
    return make


def _tables(with_index):
    def make(rng, full):
        x = dict(t=_ints(rng, TABLE3[full], 1000))
        if with_index:
            x["i"] = _ints(rng, TABLE3[full], mosaic.BLOCK)
        return x
    return make


def _dma_windows(image):
    def make(rng, full):
        h, w = image[full]
        k = WINDOWS[full]
        return dict(img=_ints(rng, (h, w), 255), ax=_ints(rng, (k,), w - mosaic.WIN_COLS),
                    ay=_ints(rng, (k,), h - mosaic.WIN_ROWS))
    return make


@dataclasses.dataclass(frozen=True)
class Case:
    site: int
    name: str       # the probe's function
    source: str     # file:line of its pallas_call
    kernel: str     # key of KERNELS
    make: Callable[[np.random.Generator, bool], dict]
    args: Callable[[dict], tuple]
    note: str = ""

    @property
    def label(self) -> str:
        note = f"; {self.note}" if self.note else ""
        return f"site {self.site} {self.name} ({self.source}{note})"


def _take0(x):
    return x["src"], x["idx"], 0, x.get("blocks", 1)


def _take1(x):
    return x["src"], x["idx"], 1


def _lane_col0(x):
    return x["src"], x["idx"][:, :1].contiguous(), 1


def _windows_args(x):
    return x["img"], x["ax"], x["ay"]


CASES_P13 = [
    Case(1, "pallas_2stage", f"{P1}:93", "point_gather", _site1,
         lambda x: (x["tab"], x["r"], x["c"])),
    Case(2, "pallas_rows", f"{P1}:120", "take", _site2, lambda x: (x["tab"], x["idx"], 0),
         note="the TPU grid writes only rows < (rows // 2048) * 2048"),
    Case(3, "pallas_lane", f"{P1}:145", "take", _site3, _take1, note="1-D index"),
    Case(4, "sub_small", f"{SUBLANE}:62", "take", _sublane(np.int32, 1 << 22), _take0),
    Case(5, "sub_big", f"{SUBLANE}:91", "take", _sublane_blocks, _take0, note="block-local"),
    Case(6, "sub_u8", f"{SUBLANE}:112", "take", _sublane(np.uint8, 255), _take0, note="uint8"),
    Case(7, "relay", f"{SUBLANE}:135", "relayout", _patches,
         lambda x: (x["pat"].view(x["pat"].shape[0], -1), True)),
    Case(8, "sub_gather", f"{FORMULATIONS}:101", "take", _sublane_blocks, _take0,
         note="does not trace in JAX; serves its intended function, site 9's"),
    Case(9, "sub_gather2", f"{FORMULATIONS}:121", "take", _sublane_blocks, _take0,
         note="block-local"),
    Case(10, "gather_big", f"{FORMULATIONS}:163", "take", _lane(LANE_ROWS[10], 1000), _take1),
    Case(11, "lane_scaled(8)", f"{BLOCKS}:84", "take", _lane(LANE_ROWS[8], 1 << 22), _take1),
    Case(11, "lane_scaled(32)", f"{BLOCKS}:84", "take", _lane(LANE_ROWS[32], 1 << 22), _take1),
    Case(12, "f_sub", f"{BLOCKS}:111", "take", _square(SQUARE_BLOCKS[1]), _take0),
    Case(13, "f_sub_big", f"{BLOCKS}:121", "take", _square(SQUARE_BLOCKS[32]), _take0, note="block-local"),
    Case(14, "f_resh", f"{BLOCKS}:144", "relayout", _patches,
         lambda x: (x["pat"].view(-1, x["pat"].shape[-1]), False)),
    Case(15, "f_dma", f"{BLOCKS}:182", "window_copy", _windows, _windows_args),
    Case(16, "f_dma2", f"{BLOCKS}:238", "window_copy", _windows, _windows_args),
]

CASES_P2 = [
    Case(17, "probe(a)", f"{MOSAIC}:20", "take", _gather(TABLE17, SHORT17, 0), _take0,
         note="axis 0, idx (8, 128)"),
    Case(17, "probe(b)", f"{MOSAIC}:20", "take", _gather(TABLE17, TABLE17, 0), _take0,
         note="axis 0"),
    Case(17, "probe(c)", f"{MOSAIC}:20", "take", _gather(TABLE17, TABLE17, 0, np.float32),
         _take0, note="axis 0, float32"),
    Case(17, "probe(d)", f"{MOSAIC}:20", "take", _gather(TABLE17, TABLE17, 1), _take1,
         note="axis 1"),
    Case(17, "probe(e)", f"{MOSAIC}:20", "take", _gather(TABLE17, COL17, 1), _take1,
         note="axis 1, idx (256, 1)"),
    Case(17, "probe(f)", f"{MOSAIC}:20", "take", _gather(TABLE17, TABLE17, 1, np.float32),
         _take1, note="axis 1, float32"),
    Case(17, "probe(g)", f"{MOSAIC}:20", "lane_select",
         _gather(TABLE17, TABLE17, 1, np.float32), _lane_col0,
         note="one-hot lane select, served by G1 on index column 0"),
    Case(18, "taa1(a)", f"{MOSAIC2}:25", "take",
         _gather(_scales((256, 256), (16, 256)), LANE18, 1), _take1),
    Case(18, "taa1(b)", f"{MOSAIC2}:25", "take",
         _gather(_scales((256, 2432), (16, 2432)), LANE18, 1), _take1),
    Case(18, "taa1(c)", f"{MOSAIC2}:25", "take",
         _gather(_scales((8, 65536), (8, 4096)), _scales((8, 128), (8, 128)), 1), _take1),
    Case(18, "taa1(d)", f"{MOSAIC2}:25", "take", _gather(LANE18, LANE18, 1, np.uint8, 255),
         _take1, note="uint8"),
    Case(18, "taa1(e)", f"{MOSAIC2}:25", "take", _gather(TABLE3, TABLE3, 1), _take1),
    Case(19, "wide", f"{MOSAIC2}:106", "take", _gather(WIDE19, WIDE19_IDX, 1), _take1,
         note="one source block shared by every grid step"),
    Case(20, "gather_big", f"{MOSAIC3}:61", "take", _gather(TABLE3, TABLE3, 1), _take1),
    Case(21, "transpose_many", f"{MOSAIC3}:86", "transpose_chain", _tables(False),
         lambda x: (x["t"],), note="equals t + 8"),
    Case(22, "chain", f"{MOSAIC3}:107", "gather_chain", _tables(True),
         lambda x: (x["t"], x["i"])),
    Case(23, "dma_patches", f"{MOSAIC3}:145", "window_colsum", _dma_windows(IMAGE23),
         _windows_args, note="one window per grid step"),
    Case(24, "gather8", f"{MOSAIC3}:173", "take_widen",
         _gather(TABLE3, TABLE3, 1, np.uint8, 255),
         lambda x: (x["src"], x["idx"], 1, 1, torch.int32), note="uint8 to int32"),
    *(Case(25, f"gather_big({t[True][0]})", f"{MOSAIC4}:35", "take", _gather(t, t, 1), _take1)
      for t in SCALED25),
    Case(26, "dma_patches", f"{MOSAIC4}:87", "window_colsum", _dma_windows(IMAGE26),
         _windows_args, note="eight windows per grid step"),
]

CASES = CASES_P13 + CASES_P2


def tensors(case: Case, full: bool, device, seed: int | None = None) -> dict:
    """The case's inputs as tensors on ``device`` (ints stay ints)."""
    rng = np.random.default_rng(case.site if seed is None else seed)
    return {k: torch.from_numpy(v).to(device) if isinstance(v, np.ndarray) else v
            for k, v in case.make(rng, full).items()}


class _Shapes:
    """Stands in for ``np.random.Generator`` in a case's maker: each draw is
    a zero-strided view of its lower bound, so the maker gives every
    input's shape and dtype without allocating its tables."""

    def integers(self, low, high=None, size=None, dtype=np.int64):
        return np.broadcast_to(np.asarray(low, dtype=dtype), () if size is None else size)


def take_geometry(case: Case, full: bool = True) -> gather.TakeGeometry:
    """A G1 case's geometry from shapes alone (its inputs as meta tensors)."""
    meta = {k: torch.empty(v.shape, dtype=torch.from_numpy(np.empty(0, v.dtype)).dtype,
                           device="meta") if isinstance(v, np.ndarray) else v
            for k, v in case.make(_Shapes(), full).items()}
    args = case.args(meta)
    src, idx, axis, blocks, out_dtype = (*args, *(1, None)[len(args) - 3:])
    return gather.take_geometry(src.shape, idx.shape, axis, blocks, src.dtype, out_dtype)


# ---- The one PyTorch call that computes each kernel's function, timed as
# a yardstick only.

def _library_take(src, idx, axis, blocks=1, out_dtype=None):
    if idx.dim() == 1:
        out = torch.gather(src, 1, idx[:, None])
    elif axis == 1 and idx.shape[0] != src.shape[0]:  # one source, shared by row blocks
        copies = idx.shape[0] // src.shape[0]
        out = torch.gather(src.expand(copies, *src.shape), 2, idx.view(copies, src.shape[0], -1))
    elif axis == 1:
        out = torch.gather(src, 1, idx)
    else:
        w = idx.shape[1]
        out = torch.gather(src.view(blocks, -1, w), 1, idx.view(blocks, -1, w))
    return out if out_dtype is None else out.to(out_dtype)


def _library_point(tab, r, c):
    return tab[r, c]


def _library_window(img, ax, ay):
    return img.unfold(0, 64, 1).unfold(1, 64, 1)[ay.long(), ax.long()].reshape(-1, 64)


@dataclasses.dataclass(frozen=True)
class Kernel:
    label: str                 # G1, G2, C, W, T, X, S
    counter: str               # key of _kernels.LAUNCHES
    source: str
    names: tuple[str, ...]     # its CUDA kernels' names, as the profiler lists them
    wrapper: Callable
    plain: Callable
    library: Callable | None   # None: no one PyTorch call computes it
    library_name: str
    nbytes: Callable
    int32_ops: Callable | None = None
    plan: Callable | None = None  # the plan that serves a call of the wrapper, if it has one


GATHER_CU = "ethzasl_brisk_tpu_torch/csrc/probe_gather.cu"
COPY_CU = "ethzasl_brisk_tpu_torch/csrc/probe_copy.cu"
MOSAIC_CU = "ethzasl_brisk_tpu_torch/csrc/probe_mosaic.cu"
_G1 = dict(label="G1", counter="probe_take", source=GATHER_CU,
           names=("take_direct_kernel", "take_rows_kernel", "take_lanes_kernel"),
           wrapper=gather.take_along_axis, library=_library_take,
           nbytes=gather.take_along_axis_bytes, plan=gather.take_plan_for)

KERNELS = {
    "take": Kernel(**_G1, plain=gather.take_along_axis_plain, library_name="torch.gather"),
    "take_widen": Kernel(**_G1, plain=gather.take_along_axis_plain,
                         library_name="torch.gather then .int()"),
    "lane_select": Kernel(**_G1, plain=gather.lane_select_plain, library_name="torch.gather"),
    "point_gather": Kernel("G2", "probe_point_gather", GATHER_CU,
                           ("point_gather4_kernel", "point_gather_kernel"),
                           gather.point_gather, gather.point_gather_plain, _library_point,
                           "tab[r, c]", gather.point_gather_bytes,
                           plan=gather.point_plan_for),
    "relayout": Kernel("C", "probe_relayout", COPY_CU,
                       ("relayout_copy_kernel", "relayout_transpose16_kernel",
                        "relayout_transpose_kernel"),
                       gather.relayout, gather.relayout_plain, gather.relayout_plain,
                       ".T.contiguous() / .clone()", gather.relayout_bytes),
    "window_copy": Kernel("W", "probe_window_copy", COPY_CU,
                          ("window_copy16_kernel", "window_copy_kernel"),
                          gather.window_copy, gather.window_copy_plain, _library_window,
                          "img.unfold(0, 64, 1).unfold(1, 64, 1)[ay, ax].reshape(-1, 64)",
                          gather.window_copy_bytes, plan=gather.window_plan_for),
    "transpose_chain": Kernel("T", "probe_transpose_chain", MOSAIC_CU,
                              ("transpose_chain_kernel",), mosaic.transpose_chain,
                              mosaic.transpose_chain_plain, lambda t: t + 8, "t + 8",
                              mosaic.transpose_chain_bytes, mosaic.transpose_chain_ops),
    "gather_chain": Kernel("X", "probe_gather_chain", MOSAIC_CU, ("gather_chain_kernel",),
                           mosaic.gather_chain, mosaic.gather_chain_plain, None, "none",
                           mosaic.gather_chain_bytes),
    "window_colsum": Kernel("S", "probe_window_colsum", MOSAIC_CU, ("window_colsum_kernel",),
                            mosaic.window_colsum, mosaic.window_colsum_plain, None, "none",
                            mosaic.window_colsum_bytes, mosaic.window_colsum_ops),
}


def run_case(case: Case, device: torch.device, card: str, reps: int = 10) -> dict:
    """One call of a site at full size on the card: counted launch, bitwise
    check, times and bound. Returns its record."""
    kern = KERNELS[case.kernel]
    x = tensors(case, True, device)
    args = case.args(x)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    got = kern.wrapper(*args)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _kernels.LAUNCHES.items() if v}
    if launches != {kern.counter: 1}:
        raise RuntimeError(f"{case.label}: launches {launches}, expected {{{kern.counter}: 1}}")
    ref = kern.plain(*args)
    torch.cuda.synchronize()
    if got.dtype != ref.dtype or not torch.equal(got, ref):
        raise AssertionError(f"{case.label}: {kern.label} differs from its plain version")
    err = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max()) if got.numel() else 0
    plan = kern.plan(*args).label if kern.plan else None
    ms = measure.cuda_time(lambda: kern.wrapper(*args), reps=reps)
    # One launch a call (checked above): calls the profiler cut are known.
    device_ms = measure.device_time(lambda: kern.wrapper(*args), device, kern.names, reps=reps,
                                    per_call=1)
    plain_ms = measure.cuda_time(lambda: kern.plain(*args), reps=reps)
    library_ms = library_device_ms = None
    if kern.library:
        library_ms = measure.cuda_time(lambda: kern.library(*args), reps=reps)
        library_device_ms = measure.device_time(lambda: kern.library(*args), device, reps=reps)
    nbytes = kern.nbytes(*args)
    ops = kern.int32_ops(*args) if kern.int32_ops else 0
    bound, bound_by = measure.bound_ms(nbytes, int32_ops=ops)
    rec = dict(site=case.site, name=case.name, source=case.source, kernel=case.kernel,
               shapes={k: tuple(v.shape) for k, v in x.items() if torch.is_tensor(v)},
               plan=plan, launches=1, max_abs_err=err, ms=ms, device_ms=device_ms,
               plain_ms=plain_ms, library_ms=library_ms, library_device_ms=library_device_ms,
               bound_ms=bound, bound_by=bound_by, bytes=nbytes, int32_ops=ops,
               elements_per_s=got.numel() / (device_ms * 1e-3))
    lib = (f"{library_ms:.4f} ms (device {library_device_ms:.4f} ms)"
           if library_ms is not None else "none")
    via = f"{kern.label}, {plan}" if plan else kern.label
    print(
        f"[probes] {case.label} via {via}: {rec['shapes']} -> {tuple(got.shape)} "
        f"{got.dtype}; 1 launch; bitwise equal to plain; kernel {ms:.4f} ms (device "
        f"{device_ms:.4f} ms), plain {plain_ms:.4f} ms, library ({kern.library_name}) {lib}, "
        f"bound {bound:.4f} ms ({bound_by}: {nbytes} B, {ops} int32 ops); "
        f"{rec['elements_per_s']:.4g} elements/s of device time [{card}]",
        flush=True,
    )
    return rec


def run_all(device: torch.device, card: str, reps: int = 10) -> list[dict]:
    """Every case in turn, each one's tensors freed before the next."""
    records = []
    for case in CASES:
        records.append(run_case(case, device, card, reps))
        torch.cuda.empty_cache()
    return records


def kernel_rows(records: list[dict]) -> list[dict]:
    """One row per kernel for chip_smoke's ``kernels`` line: each site it
    serves once (times, bounds and launches summed over its calls; bound by
    what bounds the larger share of the summed bound)."""
    rows = []
    for counter in dict.fromkeys(k.counter for k in KERNELS.values()):
        kern = next(k for k in KERNELS.values() if k.counter == counter)
        recs = [r for r in records if KERNELS[r["kernel"]].counter == counter]
        libs = [r["library_ms"] for r in recs if r["library_ms"] is not None]
        lib_dev = [r["library_device_ms"] for r in recs if r["library_device_ms"] is not None]
        by = {b: sum(r["bound_ms"] for r in recs if r["bound_by"] == b)
              for b in ("bytes", "operations")}
        rows.append(dict(
            name=counter, route="cuda", source=kern.source,
            replaces=", ".join(dict.fromkeys(r["source"] for r in recs)),
            launches=sum(r["launches"] for r in recs),
            max_abs_err=max(r["max_abs_err"] for r in recs),
            ms=sum(r["ms"] for r in recs), device_ms=sum(r["device_ms"] for r in recs),
            plain_ms=sum(r["plain_ms"] for r in recs),
            bound_ms=sum(r["bound_ms"] for r in recs), bound_by=max(by, key=by.get),
            library_ms=sum(libs) if len(libs) == len(recs) else None,
            library_device_ms=sum(lib_dev) if len(lib_dev) == len(recs) else None,
        ))
    return rows
