"""The sixteen ``pallas_call`` sites of the TPU gather probes P1 and P3, and
the run that holds each site's kernel against its plain version on the card.

One ``Case`` per site (site 11, ``lane_scaled``, runs at the probe's two
scales, so it has two): the probe's function name and the file:line of its
``pallas_call``, an input maker at the probe's full shapes or at a small test
shape, drawn from ``np.random.default_rng`` with the probe's value and index
distributions, and the kernel that serves it (``probes/gather.py``). All
indices are int32 and in range, as in every probe.

Traps kept in view here and in the tests:

* site 2 (``pallas_rows``) runs a grid of ``rows // 2048`` blocks, so the TPU
  kernel never writes its last ``rows % 2048`` output rows; the port writes
  them all and the comparison with the JAX probe covers the written rows;
* site 8 (``sub_gather``) does not trace in JAX (``take_along_axis`` on the
  3-D blocks raises ``ValueError: Incompatible shapes for broadcasting``);
  the port serves its intended function, site 9's;
* sites 5, 8, 9 and 13 gather block-local rows, site 2 global rows;
* site 6's source and output are uint8.

``run_all`` is what ``python -m ethzasl_brisk_tpu_torch.probes`` and the
``[probes]`` phase of ``chip_smoke.py`` run: each case once with the launch
counters set to 0 just before and read just after, bitwise against the plain
version, then timed against the plain version and the one PyTorch call that
computes the same function, beside its bound. Nothing is caught: a mismatch
or a launch error ends the run.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ethzasl_brisk_tpu_torch import _kernels, measure
from ethzasl_brisk_tpu_torch.probes import gather

P1 = "tools/bench_pallas_gather.py"
SUBLANE = "tools/probes/probe_sublane_gather.py"
FORMULATIONS = "tools/probes/probe_gather_formulations.py"
BLOCKS = "tools/probes/probe_sampler_blocks.py"

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


CASES = [
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
    Case(15, "f_dma", f"{BLOCKS}:182", "window_copy", _windows,
         lambda x: (x["img"], x["ax"], x["ay"])),
    Case(16, "f_dma2", f"{BLOCKS}:238", "window_copy", _windows,
         lambda x: (x["img"], x["ax"], x["ay"])),
]


def tensors(case: Case, full: bool, device, seed: int | None = None) -> dict:
    """The case's inputs as tensors on ``device`` (ints stay ints)."""
    rng = np.random.default_rng(case.site if seed is None else seed)
    return {k: torch.from_numpy(v).to(device) if isinstance(v, np.ndarray) else v
            for k, v in case.make(rng, full).items()}


# ---- The one PyTorch call that computes each kernel's function, timed as
# a yardstick only.

def _library_take(src, idx, axis, blocks=1):
    if idx.dim() == 1:
        return torch.gather(src, 1, idx[:, None])
    if axis == 1:
        return torch.gather(src, 1, idx)
    w = idx.shape[1]
    return torch.gather(src.view(blocks, -1, w), 1, idx.view(blocks, -1, w))


def _library_point(tab, r, c):
    return tab[r, c]


@dataclasses.dataclass(frozen=True)
class Kernel:
    label: str                 # G1, G2, C, W
    counter: str               # key of _kernels.LAUNCHES
    source: str
    wrapper: Callable
    plain: Callable
    library: Callable | None   # None: no one PyTorch call computes it
    library_name: str
    nbytes: Callable


KERNELS = {
    "take": Kernel("G1", "probe_take", "ethzasl_brisk_tpu_torch/csrc/probe_gather.cu",
                   gather.take_along_axis, gather.take_along_axis_plain, _library_take,
                   "torch.gather", gather.take_along_axis_bytes),
    "point_gather": Kernel("G2", "probe_point_gather",
                           "ethzasl_brisk_tpu_torch/csrc/probe_gather.cu",
                           gather.point_gather, gather.point_gather_plain, _library_point,
                           "tab[r, c]", gather.point_gather_bytes),
    "relayout": Kernel("C", "probe_relayout", "ethzasl_brisk_tpu_torch/csrc/probe_copy.cu",
                       gather.relayout, gather.relayout_plain, gather.relayout_plain,
                       ".T.contiguous() / .clone()", gather.relayout_bytes),
    "window_copy": Kernel("W", "probe_window_copy",
                          "ethzasl_brisk_tpu_torch/csrc/probe_copy.cu",
                          gather.window_copy, gather.window_copy_plain, None, "none",
                          gather.window_copy_bytes),
}


def run_case(case: Case, device: torch.device, card: str, reps: int = 10) -> dict:
    """One site at full size on the card: counted launch, bitwise check,
    times and bound. Returns its record."""
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
    ms = measure.cuda_time(lambda: kern.wrapper(*args), reps=reps)
    plain_ms = measure.cuda_time(lambda: kern.plain(*args), reps=reps)
    library_ms = (measure.cuda_time(lambda: kern.library(*args), reps=reps)
                  if kern.library else None)
    nbytes = kern.nbytes(*args)
    bound, bound_by = measure.bound_ms(nbytes)
    rec = dict(site=case.site, name=case.name, source=case.source, kernel=case.kernel,
               shapes={k: tuple(v.shape) for k, v in x.items() if torch.is_tensor(v)},
               launches=1, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound, bound_by=bound_by, bytes=nbytes,
               elements_per_s=got.numel() / (ms * 1e-3))
    lib = f"{library_ms:.4f} ms" if library_ms is not None else "none"
    print(
        f"[probes] {case.label} via {kern.label}: {rec['shapes']} -> {tuple(got.shape)} "
        f"{got.dtype}; 1 launch; bitwise equal to plain; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library ({kern.library_name}) {lib}, bound {bound:.4f} ms "
        f"({bound_by}, {nbytes} B); {rec['elements_per_s']:.4g} elements/s [{card}]",
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
    serves once (times, bounds and launches summed over them)."""
    rows = []
    for key, kern in KERNELS.items():
        recs = [r for r in records if r["kernel"] == key]
        sites = list(dict.fromkeys(r["source"] for r in recs))
        rows.append(dict(
            name=kern.counter, route="cuda", source=kern.source, replaces=", ".join(sites),
            launches=sum(r["launches"] for r in recs),
            max_abs_err=max(r["max_abs_err"] for r in recs),
            ms=sum(r["ms"] for r in recs), plain_ms=sum(r["plain_ms"] for r in recs),
            bound_ms=sum(r["bound_ms"] for r in recs),
            bound_by="bytes",
            library_ms=(sum(r["library_ms"] for r in recs) if kern.library else None),
        ))
    return rows
