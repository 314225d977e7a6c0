"""The launch layout of ``csrc/probe_mosaic.cu``'s S and X, read from the
kernel source's own constants, and their index arithmetic replayed in numpy.

S gives each window a CTA of 8 warps, warp w summing rows w + 8 i and lane
l columns l + 32 j; X stages a 128 x 128 block's t as it lies and its i
transposed in padded rows, then serves each thread's outputs from there.
These tests check that the CTAs, warps and lanes cover every window, row,
column and chunk once, that shared memory stays within a block's, that X's
transposing stores spread over the 32 banks, and that the replayed kernels
give the plain versions' results.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from ethzasl_brisk_tpu_torch.probes import gather, mosaic

BANKS = 32
MOSAIC_CU = pathlib.Path(mosaic.__file__).parent.parent / "csrc" / "probe_mosaic.cu"


def _cu_constants() -> dict:
    """The ``constexpr int`` constants of probe_mosaic.cu, evaluated in
    order (C's integer division as Python's floor division: all are
    positive)."""
    env: dict = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", MOSAIC_CU.read_text()):
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))
    return env


CU = _cu_constants()


def test_layout_constants_match_the_wrappers():
    assert (CU["kBlk"], CU["kWinRows"], CU["kWinCols"]) == (
        mosaic.BLOCK, mosaic.WIN_ROWS, mosaic.WIN_COLS)
    assert CU["kColThreads"] == 32 * CU["kColWarps"] == 256
    assert CU["kColRows"] * CU["kColWarps"] == CU["kWinRows"]
    assert CU["kChainThreads"] == 512


def test_shared_memory_within_a_block():
    """S: 8 warps' sums of 128 words in static shared memory, 4 KB; X: t's
    block and i's transposed block with its padded rows, 129 KB."""
    assert 4 * CU["kColWarps"] * CU["kWinCols"] == 4096 <= 48 * 1024
    assert CU["kChainSmem"] == 4 * 128 * (128 + 130) == 132_096 <= gather.SMEM_LIMIT == 232_448


# ---- S: the kernel's loads and sums, warp by warp.

def _colsum_mirror(img: np.ndarray, ax, ay) -> np.ndarray:
    """csrc/probe_mosaic.cu:window_colsum_kernel in numpy: CTA k serves
    window k; warp w sums rows ay + w + 8 i (i < 12), lane l columns
    ax + l + 32 j (j < 4); the warps' sums are added per column. Sums wrap
    as uint32."""
    warps, rows = CU["kColWarps"], CU["kColRows"]
    u = img.astype(np.int64) & 0xFFFFFFFF
    ax, ay = np.asarray(ax, np.int64), np.asarray(ay, np.int64)
    cols = ax[:, None] + np.arange(CU["kWinCols"])               # (K, 128), lane c % 32
    sums = np.zeros((len(ax), warps, CU["kWinCols"]), np.int64)
    for w in range(warps):
        r = ay[:, None] + w + warps * np.arange(rows)            # (K, 12)
        sums[:, w] = u[r[:, :, None], cols[:, None, :]].sum(1)
    return (sums.sum(1) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def test_colsum_warps_and_lanes_cover_the_window_once():
    warps, rows = CU["kColWarps"], CU["kColRows"]
    r = np.arange(warps)[:, None] + warps * np.arange(rows)
    assert np.array_equal(np.sort(r.ravel()), np.arange(mosaic.WIN_ROWS))
    c = np.arange(32)[:, None] + 32 * np.arange(4)
    assert np.array_equal(np.sort(c.ravel()), np.arange(mosaic.WIN_COLS))


@pytest.mark.parametrize("k", [1, 3, 512, 513])
@pytest.mark.parametrize("h,width", [(120, 200), (97, 132), (96, 128), (150, 768)])
def test_colsum_kernel_arithmetic_matches_plain(h, width, k):
    """K windows, one CTA each, at every ax % 4, at both image edges and one
    to three columns short of the right edge, on values near +-2^31 so the
    sums wrap."""
    rng = np.random.default_rng(41)
    img = rng.integers(-2**31, 2**31, (h, width), dtype=np.int64).astype(np.int32)
    img[:, :3] = 2**31 - 1
    xs = np.r_[0, 1, 2, 3, width - 128, width - 129, width - 131, rng.integers(0, width - 127, k)]
    ys = np.r_[0, h - 96, 1, 0, h - 96, 0, h - 96, rng.integers(0, h - 95, k)]
    ax = np.clip(xs[:k], 0, width - 128).astype(np.int32)
    ay = np.clip(ys[:k], 0, h - 96).astype(np.int32)
    want = mosaic.window_colsum_plain(*map(torch.from_numpy, (img, ax, ay))).numpy()
    got = _colsum_mirror(img, ax, ay)
    assert got.shape == (k, mosaic.WIN_COLS)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("width", [768, 130])
@pytest.mark.parametrize("offset", [0, 1, 2, 3, 4])
def test_colsum_on_offset_views(width, offset):
    """A view ``offset`` elements into its storage: the CPU wrapper (the
    plain version) gives the view's sums, as the kernel does on any
    alignment."""
    h = 100
    store = torch.arange(h * width + offset, dtype=torch.int32)
    img = store[offset:].view(h, width)
    ax = torch.tensor([0, 1, 2, 3, width - 128], dtype=torch.int32).clamp(max=width - 128)
    ay = torch.tensor([0, 4, 1, h - 96, h - 96], dtype=torch.int32)
    got = mosaic.window_colsum(img, ax, ay)
    assert torch.equal(got, mosaic.window_colsum_plain(img.clone(), ax, ay))
    assert torch.equal(got, torch.from_numpy(_colsum_mirror(img.numpy(), ax.numpy(),
                                                            ay.numpy())))


# ---- X: the kernel's staging and serving, lane by lane.

def _chain_lanes():
    """csrc/probe_mosaic.cu:gather_chain_kernel's chunk of i for each
    (warp, n, lane): row k and chunk q of the 128 x 32 chunks."""
    warps = CU["kChainThreads"] // 32
    warp, n, lane = np.meshgrid(np.arange(warps), np.arange(4096 // CU["kChainThreads"]),
                                np.arange(32), indexing="ij")
    tile = warp + warps * n
    return 8 * (tile % 16) + lane % 8, 4 * (tile // 16) + lane // 8


def test_chain_chunks_cover_the_block_once():
    """Every 16-byte chunk of i and of t is loaded by one thread: i as
    tiles of 8 rows x 4 chunks, t as one 512-byte row a warp."""
    k, q = _chain_lanes()
    assert np.array_equal(np.sort((k * 32 + q).ravel()), np.arange(4096))
    threads = CU["kChainThreads"]
    thread = np.arange(threads)[:, None] + threads * np.arange(4096 // threads)
    assert np.array_equal(np.sort(thread.ravel()), np.arange(4096))


def test_chain_staging_stores_spread_over_the_banks():
    """The transposing stores of word j of a warp's chunks, iT[4q + j][k],
    fall on 32 distinct banks; t's 16-byte stores, a quarter-warp at a time,
    on all 32; the 16-byte loads of i read whole 32-byte sectors."""
    k, q = _chain_lanes()
    for j in range(4):
        banks = ((4 * q + j) * CU["kChainPitch"] + k) % BANKS
        assert all(len(set(b)) == BANKS for b in banks.reshape(-1, 32))
    chunk = np.arange(CU["kChainThreads"]).reshape(-1, 8)  # quarter-warps
    banks = (4 * chunk[..., None] + np.arange(4)) % BANKS
    assert all(len(set(b.ravel())) == BANKS for b in banks)
    sectors = (k * 32 + q) * 16 // 32
    assert all(len(set(s)) == 16 for s in sectors.reshape(-1, 32))


@pytest.mark.parametrize("index", ["random", "zeros", "127"])
def test_chain_kernel_arithmetic_matches_plain(index):
    """Stage t as it lies and i transposed in rows of kChainPitch words,
    then serve each thread's 32 outputs from the staged block: equal to the
    plain version on 3 blocks, t over the whole int32 range."""
    rng = np.random.default_rng(42)
    nblk = 3
    t = rng.integers(-2**31, 2**31, (nblk * 128, 128), dtype=np.int64).astype(np.int32)
    i = {"random": rng.integers(0, 128, t.shape), "zeros": np.zeros(t.shape),
         "127": np.full(t.shape, 127)}[index].astype(np.int32)
    k, q = _chain_lanes()
    out = np.zeros_like(t)
    pitch = CU["kChainPitch"]
    for b in range(nblk):
        ib, tb = i[128 * b:128 * (b + 1)], t[128 * b:128 * (b + 1)]
        ts = tb.reshape(-1)
        it = np.zeros(128 * pitch, np.int32)
        kv = ib.reshape(128, 32, 4)[k, q]                 # each thread's chunks of i
        for j in range(4):
            it[(4 * q + j) * pitch + k] = kv[..., j]
        m = it[k[..., None] * pitch + kv]                 # iT[k][i[k, 4q + j]]
        served = ts[kv * 128 + m]
        out[128 * b:128 * (b + 1)].reshape(128, 32, 4)[k, q] = served
    want = mosaic.gather_chain_plain(torch.from_numpy(t), torch.from_numpy(i)).numpy()
    assert np.array_equal(out, want)
