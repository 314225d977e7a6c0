"""G2's and W's plans (``probes/gather.py``: ``point_plan``, ``window_plan``)
and their kernels' index arithmetic, read from the ``.cu`` sources' own
constants and replayed in numpy.

G2 (``csrc/probe_gather.cu``) serves four taps a thread with 16-byte moves
of r, c and out where all three are 16-byte aligned, the first threads of
CTA 0 taking the last n % 4 taps one a thread, and one tap a thread
elsewhere. W (``csrc/probe_copy.cu``) copies each window with four CTAs of
16-byte moves where the image and its rows are 16-byte aligned: a lane
loads two aligned chunks of its row and keeps the four words ``ax % 4``
in; word loads elsewhere. These tests check that every output is written
exactly once, that no load leaves its image row, that the replayed kernels
give the plain versions' results, that misaligned bases and ragged widths
go to the scalar bodies, and that W's library yardstick equals the plain
version.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from ethzasl_brisk_tpu_torch.probes import cases, gather

CSRC = pathlib.Path(gather.__file__).parent.parent / "csrc"


def _cu_constants(name: str) -> dict:
    """The file-scope ``constexpr int`` constants of a csrc file, evaluated
    in order (C's integer division as Python's floor division: all are
    positive)."""
    env: dict = {}
    text = (CSRC / name).read_text()
    for key, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", text, re.M):
        env[key] = eval(expr.replace("/", "//"), {}, dict(env))
    return env


G = _cu_constants("probe_gather.cu")
C = _cu_constants("probe_copy.cu")


def test_launch_constants_match_the_plans():
    assert (G["kPointThreads"], G["kPointTaps"], G["kThreads"]) == (
        gather.POINT_THREADS, gather.POINT_TAPS, gather.SCALAR_THREADS)
    assert G["kPointThreads"] * G["kPointTaps"] == 2048  # one cluster of site 1's taps a CTA
    assert (C["kWin"], C["kWinSplit"], C["kWinThreads"]) == (
        gather.WINDOW, gather.WINDOW_SPLIT, 256)
    # The 16-byte body: a CTA's rows x 16 chunks, a chunk a thread, whole warps
    # of two rows each.
    assert C["kSplitRows"] * C["kWinSplit"] == C["kWin"]
    assert C["kChunkThreads"] == C["kSplitRows"] * 16 == 256


# ---- G2.

def _point_mirror(tab: np.ndarray, r: np.ndarray, c: np.ndarray, plan: gather.PointPlan):
    """csrc/probe_gather.cu's G2 in numpy: the taps each thread of each CTA
    serves under ``plan``. Returns (out, how many times each tap was written)."""
    n = r.shape[0]
    if plan.vector:
        quads = n // G["kPointTaps"]
        q = (np.arange(plan.grid)[:, None] * G["kPointThreads"]
             + np.arange(G["kPointThreads"])).ravel()
        q = q[q < quads]
        taps = (G["kPointTaps"] * q[:, None] + np.arange(G["kPointTaps"])).ravel()
        tail = quads * G["kPointTaps"] + np.arange(G["kPointThreads"])  # CTA 0's first threads
        taps = np.concatenate([taps, tail[tail < n]])
    else:
        taps = np.arange(plan.grid * G["kThreads"])
        taps = taps[taps < n]
    writes = np.zeros(n, np.int64)
    np.add.at(writes, taps, 1)
    out = np.zeros(n, np.int32)
    out[taps] = tab[r[taps], c[taps]]
    return out, writes


def _point_taps(rng, n, rows, cols):
    tab = rng.integers(-2**31, 2**31, (rows, cols), dtype=np.int64).astype(np.int32)
    r = rng.integers(0, rows, n).astype(np.int32)
    c = rng.integers(0, cols, n).astype(np.int32)
    r[:1], c[-1:] = rows - 1, cols - 1
    return tab, r, c


@pytest.mark.parametrize("mods", [(0, 0, 0), (4, 0, 0), (0, 8, 0), (0, 0, 12)])
@pytest.mark.parametrize("cols", [128, 130])
@pytest.mark.parametrize("n", [*range(1, 10), 2047, 2048, 2049, 5001])
def test_point_kernel_arithmetic_matches_plain(n, cols, mods):
    """Every tap written once, by the body the plan picks for these
    alignments of r, c and out (bytes past a 16-byte boundary), and equal
    to the plain version."""
    tab, r, c = _point_taps(np.random.default_rng(n), n, 97, cols)
    plan = gather.point_plan(n, *mods)
    assert plan.vector == (mods == (0, 0, 0))
    gather.check_point_plan(plan, n, *mods)
    out, writes = _point_mirror(tab, r, c, plan)
    assert (writes == 1).all()
    want = gather.point_gather_plain(*map(torch.from_numpy, (tab, r, c))).numpy()
    assert np.array_equal(out, want)


def test_point_site1_taps():
    """Site 1's clustered taps at the test's scale: whole 2048-tap runs a
    CTA on the aligned route, every tap once, equal to plain."""
    tab, r, c = cases.p1_taps(np.random.default_rng(1), False)
    plan = gather.point_plan(r.shape[0], 0, 0, 0)
    assert plan == gather.PointPlan(True, -(-r.shape[0] // 2048))
    out, writes = _point_mirror(tab, r, c, plan)
    assert (writes == 1).all()
    want = gather.point_gather_plain(*map(torch.from_numpy, (tab, r, c))).numpy()
    assert np.array_equal(out, want)
    full = cases.P1_GEOMETRY[True]
    n_full = full["n"] // full["blk"] * full["blk"]
    assert gather.point_plan(n_full, 0, 0, 0) == gather.PointPlan(True, n_full // 2048) == (True, 976)


def test_point_plan_routes_and_refuses():
    """Any misaligned r, c or out takes the scalar body, whose grid covers
    every tap; a plan the kernel cannot take raises."""
    for mods in [(4, 0, 0), (0, 4, 0), (0, 0, 4), (8, 8, 8)]:
        assert gather.point_plan(5001, *mods) == gather.PointPlan(False, 20)
    assert gather.point_plan(3, 0, 0, 0) == gather.PointPlan(True, 1)  # the tail alone
    with pytest.raises(ValueError, match="16-byte"):
        gather.check_point_plan(gather.PointPlan(True, 3), 5001, 0, 4, 0)
    with pytest.raises(ValueError, match="cover"):
        gather.check_point_plan(gather.PointPlan(True, 2), 5001, 0, 0, 0)
    with pytest.raises(ValueError, match="cover"):
        gather.check_point_plan(gather.PointPlan(False, 19), 5001, 4, 0, 0)
    with pytest.raises(ValueError, match="cover"):
        gather.check_point_plan(gather.PointPlan(True, 0), 3, 0, 0, 0)


# ---- W.

def _window_mirror(img: np.ndarray, ax: np.ndarray, ay: np.ndarray) -> np.ndarray:
    """csrc/probe_copy.cu:window_copy16_kernel in numpy: CTA u copies rows
    16 (u % 4) + t // 16 of window u // 4, thread t its chunk q = t % 16 from
    the aligned chunks q and q + 1 (the second only when ax % 4 != 0).
    Asserts that every 16-byte load lies in its image row."""
    h, width = img.shape
    k = ax.shape[0]
    u = np.arange(k * C["kWinSplit"])
    t = np.arange(C["kChunkThreads"])
    win = u[:, None] // C["kWinSplit"]
    row = (u[:, None] % C["kWinSplit"]) * C["kSplitRows"] + t // 16       # (CTAs, threads)
    s = np.broadcast_to(ax[win] & 3, row.shape)
    col = (ax[win] & ~3) + 4 * (t % 16)                                  # chunk q's first word
    y = ay[win] + row
    assert col.min() >= 0 and (col + 3).max() < width and y.max() < h
    assert ((col + 7)[s != 0] < width).all()                             # chunk q + 1
    words = np.arange(4)
    a = img[y[..., None], col[..., None] + words]                        # (CTAs, threads, 4)
    b = img[y[..., None], np.minimum(col + 4, width - 4)[..., None] + words]
    both = np.concatenate([a, np.where((s != 0)[..., None], b, a)], -1)  # 8 words
    out = np.take_along_axis(both, s[..., None] + words, -1)
    flat = np.zeros((k, C["kWin"], C["kWin"]), img.dtype)
    flat[win[..., None], row[..., None], 4 * (t % 16)[:, None] + words] = out
    return flat.reshape(-1, C["kWin"])


# (height, width): rows of whole 16-byte chunks, and one of the probe's.
WINDOW_IMAGES = [(130, 768), (97, 772), (70, 64), (488, 768)]


@pytest.mark.parametrize("k", [1, 5, 128])
@pytest.mark.parametrize("h,width", WINDOW_IMAGES)
def test_window_kernel_arithmetic_matches_plain(h, width, k):
    """Windows at every ax % 4, at both image edges and one to three
    columns short of the right edge, over the whole int32 range."""
    rng = np.random.default_rng(width + k)
    img = rng.integers(-2**31, 2**31, (h, width), dtype=np.int64).astype(np.int32)
    ax = rng.integers(0, width - 63, k).astype(np.int32)
    ay = rng.integers(0, h - 63, k).astype(np.int32)
    edges = [(width - 64, h - 64), (0, 0), (1, h - 64), (2, 1), (3, 0), (width - 65, 2),
             (width - 66, 0), (width - 67, h - 64)]
    for i, (x, y) in enumerate(edges[:k]):
        ax[i], ay[i] = min(max(x, 0), width - 64), y
    assert gather.window_plan(width, 0, 0).vector
    want = gather.window_copy_plain(*map(torch.from_numpy, (img, ax, ay))).numpy()
    assert np.array_equal(_window_mirror(img, ax, ay), want)


@pytest.mark.parametrize("site", [15, 16])
def test_window_sites_match_plain(site):
    """Sites 15 and 16 at the test's scale: the 16-byte route, replayed,
    equal to plain."""
    case = next(c for c in cases.CASES if c.site == site)
    x = cases.tensors(case, False, "cpu")
    assert gather.window_plan_for(x["img"], x["ax"], x["ay"]).vector
    got = _window_mirror(x["img"].numpy(), x["ax"].numpy(), x["ay"].numpy())
    assert np.array_equal(got, gather.window_copy_plain(x["img"], x["ax"], x["ay"]).numpy())


@pytest.mark.parametrize("width,rows_whole", [(768, True), (772, True), (101, False), (64, True)])
def test_window_plan_routes_and_refuses(width, rows_whole):
    """The 16-byte body only where the image's rows are whole 16-byte chunks
    (4 * width bytes) and the image and output bases are aligned; anything
    else takes the word loads, and a 16-byte plan there raises."""
    assert (4 * width % 16 == 0) == rows_whole
    for img_mod, out_mod in [(0, 0), (4, 0), (8, 0), (12, 0), (0, 4)]:
        plan = gather.window_plan(width, img_mod, out_mod)
        assert plan.vector == (rows_whole and img_mod == out_mod == 0)
        gather.check_window_plan(plan, width, img_mod, out_mod)
        gather.check_window_plan(gather.WindowPlan(False), width, img_mod, out_mod)
        if not plan.vector:
            with pytest.raises(ValueError, match="16-byte"):
                gather.check_window_plan(gather.WindowPlan(True), width, img_mod, out_mod)


@pytest.mark.parametrize("width", [768, 101])
@pytest.mark.parametrize("offset", [0, 1, 4])
def test_window_copy_on_offset_views(width, offset):
    """A view ``offset`` elements into its storage: the plan sees its base
    (4 bytes past a boundary takes the word loads, 16 bytes past does not),
    and the CPU wrapper gives the view's windows."""
    h = 100
    store = torch.arange(h * width + offset, dtype=torch.int32)
    img = store[offset:].view(h, width)
    ax = torch.tensor([0, 1, 2, 3, width - 64], dtype=torch.int32)
    ay = torch.tensor([0, 4, 1, h - 64, h - 64], dtype=torch.int32)
    plan = gather.window_plan(width, img.data_ptr() % 16, 0)
    assert plan.vector == (width % 4 == 0 and 4 * offset % 16 == 0)
    got = gather.window_copy(img, ax, ay)
    assert torch.equal(got, gather.window_copy_plain(img.clone(), ax, ay))


@pytest.mark.parametrize("shape,k", [((130, 101), 50), ((488, 768), 128), ((64, 64), 3)])
def test_window_library_call_equals_plain(shape, k):
    """W's library yardstick, the image's windows as a strided view indexed
    at (ay, ax), is bitwise the plain version."""
    rng = np.random.default_rng(k)
    img = torch.from_numpy(rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32))
    ax = torch.from_numpy(rng.integers(0, shape[1] - 63, k).astype(np.int32))
    ay = torch.from_numpy(rng.integers(0, shape[0] - 63, k).astype(np.int32))
    got = cases._library_window(img, ax, ay)
    assert got.shape == (k * 64, 64)
    assert torch.equal(got, gather.window_copy_plain(img, ax, ay))
