"""Greedy keypoint uniformity enforcement (port of ``detect/uniformity.py``).

Reference: ``EnforceKeyPointUniformity``
(uniformity-enforcement-inl.h:44-194): a score-sorted greedy pass that
paints a saturating uint8 occupancy grid with a 31x31 radial LUT and
rejects candidates whose cell already exceeds
``sqrt(sqrt(score/max_score)) * 255``.

Four forms of one mask, bit for bit the JAX package's
``enforce_uniformity_sequential`` (and so its blocked ``enforce_uniformity``):

* ``enforce_uniformity_cuda`` launches kernel ``enforce_uniformity``
  (``csrc/uniformity.cu``) once for every layer of a detection: a CTA a
  (frame, layer) computes the cells itself and runs the sequential greedy
  in rounds (a window of ``WINDOW`` candidates tested, the first that
  passes accepted and painted), with no host sync. Each layer takes one of
  two routes, chosen from its shape, the radius and K (``layer_plan``):
  ``grid``, the reference's occupancy grid in shared memory, an accept
  painting its 31x31 patch; or ``candidates``, where the grid does not fit
  (or no shape is given), a per-candidate occupancy that each accept
  updates at every later candidate in its patch;
* ``enforce_uniformity_grid_plain`` is the grid route's line-by-line torch
  twin over a batch of problems (the same rounds, window, grid extent and
  cell arithmetic);
* ``enforce_uniformity_scan_plain`` is the candidates route's twin;
* ``enforce_uniformity_plain`` is the JAX package's blocked, exact
  formulation: candidates go in blocks of ``block``; a block's occupancy
  reading against earlier blocks is a pairwise reduction against the list
  of accepted candidates; inside the block, an interval-bound fixpoint
  resolves the greedy recurrence. That formulation exists because scatter
  is slow on the TPU; it syncs the host per block and round, so it is the
  CPU's route and the kernel's plain version on the card.

``enforce_uniformity_layers`` picks by device (one launch for all layers on
the card, the blocked form layer by layer on the CPU); ``enforce_uniformity``
is its one-layer call. ``block`` is read by the blocked form only.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ethzasl_brisk_tpu_torch import _kernels

# csrc/uniformity.cu: kThreads (the window), kMaxLayers, a CTA's shared
# memory (kMaxShared) and each route's layout in it. The candidates route:
# the LUT and two sets of warp slots (kFixedShared), then 13 bytes a
# candidate (cx, cy, test value, occ); the problems whose candidates fit
# stage there (kMaxSharedCandidates). The grid route: two sets of warp slots
# of three words rounded up to 16 bytes (kGridFixedShared), the grid
# rounded up to 16 bytes, and 8 bytes a candidate (cell, test value) where
# they fit; a grid of more than kMaxGridBytes takes the candidates route. A
# layer staged in device memory takes 13 bytes a candidate of scratch
# (kScratchBytesPerCandidate).
WINDOW = 512
MAX_LAYERS = 16
MAX_SHARED = 232448
FIXED_SHARED = 31 * 31 * 4 + 2 * (WINDOW // 32) * 4
SHARED_BYTES_PER_CANDIDATE = 13
MAX_SHARED_CANDIDATES = (MAX_SHARED - FIXED_SHARED) // SHARED_BYTES_PER_CANDIDATE
GRID_FIXED_SHARED = -(-2 * 3 * (WINDOW // 32) * 4 // 16) * 16
GRID_STAGED_BYTES_PER_CANDIDATE = 8
MAX_GRID_BYTES = MAX_SHARED - GRID_FIXED_SHARED
SCRATCH_BYTES_PER_CANDIDATE = 13
ROUTES = ("auto", "candidates")
STAGINGS = ("shared", "device")


def radial_lut() -> np.ndarray:
    """The 31x31 radial falloff LUT (scale-space-layer-inl.h:89-97)."""
    xs = np.arange(31, dtype=np.float64)
    d2 = (15.0 - xs[None, :]) ** 2 + (15.0 - xs[:, None]) ** 2
    return np.maximum(1.0 - d2 / 225.0, 0.0).astype(np.float32)


def _cells(xs, ys, scores, valid, radius):
    scaling = float(np.float32(15.0 / radius))
    scores_f = scores.to(torch.float32)
    max_score = scores_f[..., :1]  # candidates arrive sorted descending
    nsc1 = torch.sqrt(torch.sqrt(scores_f / max_score)) * 255.0
    nsc1 = torch.where(valid, nsc1, torch.zeros_like(nsc1))
    cx = (xs.to(torch.float32) * scaling + 16.0).to(torch.int32)
    cy = (ys.to(torch.float32) * scaling + 16.0).to(torch.int32)
    return nsc1, cx, cy


def grid_shape(rows: int, cols: int, radius: float) -> tuple[int, int]:
    """The grid route's occupancy grid (rows, cols) for a (rows, cols)
    layer: the largest cell (``_cells``' float32 arithmetic at the last row
    and column) plus the patch's 15 and one."""
    scaling = np.float32(15.0 / radius)

    def extent(n):
        return int(np.float32(np.float32(n - 1) * scaling) + np.float32(16.0)) + 16

    return extent(rows), extent(cols)


def layer_plan(k: int, shape, radius: float, route: str = "auto",
               staging: str = "shared") -> tuple[str, int, int, bool, int]:
    """(route, grid rows, grid cols, staged in shared memory, shared bytes)
    of one layer of K candidates a problem, from Python ints alone: the grid
    route where a ``shape`` (rows, cols) is given, ``route`` is "auto" and
    the grid fits a CTA's shared memory, its cells and test values staged
    behind it where they fit if the launch stages in shared memory
    (``staging`` "shared", as a layer launched alone does), in device
    memory if it stages there ("device", ``launch_staging``); else the
    candidates route (staged in shared memory where K fits, whatever
    ``staging`` is)."""
    if route not in ROUTES:
        raise ValueError(f"route: expected one of {ROUTES}, got {route!r}")
    if staging not in STAGINGS:
        raise ValueError(f"staging: expected one of {STAGINGS}, got {staging!r}")
    if route == "auto" and shape is not None:
        gh, gw = grid_shape(int(shape[0]), int(shape[1]), radius)
        if gh * gw <= MAX_GRID_BYTES:
            grid = GRID_FIXED_SHARED + -(-gh * gw // 16) * 16
            staged = GRID_STAGED_BYTES_PER_CANDIDATE * k
            shared = staging == "shared" and grid + staged <= MAX_SHARED
            return "grid", gh, gw, shared, grid + (staged if shared else 0)
    shared = k <= MAX_SHARED_CANDIDATES
    return ("candidates", 0, 0, shared,
            FIXED_SHARED + (SHARED_BYTES_PER_CANDIDATE * k if shared else 0))


_SMS: dict = {}  # device -> its SM count


def launch_staging(problems) -> str:
    """Where a launch's grid-route layers stage their candidates: in shared
    memory ("shared") when the launch's CTAs (a problem each) fit the
    card's SMs one an SM, and in device memory ("device") when they do not,
    so that a CTA takes about half an SM's shared memory and two run on
    each (the layer-0 grid of a VGA frame at radius 30 is 95 KB, its staged
    candidates another 80 KB)."""
    dev = problems[0][0].device
    sms = _SMS.get(dev)
    if sms is None:
        sms = _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    ctas = sum(p[0].shape[0] for p in problems if p[0].shape[1])
    return "shared" if ctas <= sms else "device"


def _pair_paint(px, py, pn, qx, qy):
    """Paint of candidates (px, py, pn) at cells (qx, qy): (..., P, Q) i32.

    max(0, (225 - d2) / 225) in f32 equals the f64-built radial LUT for
    every integer d2 and is zero beyond the 31x31 patch.
    """
    dy = (qy[..., None, :] - py[..., :, None]).to(torch.float32)
    dx = (qx[..., None, :] - px[..., :, None]).to(torch.float32)
    d2 = dy * dy + dx * dx
    lutv = torch.clamp((225.0 - d2) / 225.0, min=0.0)
    return torch.ceil(lutv * (0.99 * pn[..., :, None])).to(torch.int32)


def enforce_uniformity_plain(
    xs: torch.Tensor,
    ys: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    *,
    radius: float,
    max_num_kpt: int,
    block: int = 256,
) -> torch.Tensor:
    """Greedy uniformity mask over score-descending candidates.

    xs, ys: (N, K) int32; scores: (N, K); valid: (N, K) bool, one row per
    independent problem (frame). Returns the (N, K) bool acceptance mask.
    """
    n, k = xs.shape
    dev = xs.device
    nsc1, cx, cy = _cells(xs, ys, scores, valid, radius)

    b = min(block, k)
    n_blocks = -(-k // b)
    pad = n_blocks * b - k

    def padded(a, fill):
        return torch.nn.functional.pad(a, (0, pad), value=fill).reshape(n, n_blocks, b)

    cx_b, cy_b = padded(cx, 16), padded(cy, 16)
    nsc1_b, valid_b = padded(nsc1, 0.0), padded(valid, False)
    block_live = valid_b.any(dim=2).cpu()  # (n, n_blocks)

    cap_eff = min(max_num_kpt, n_blocks * b)
    # Accepted list per problem: the cap plus one terminal block of slack,
    # plus a last slot that takes the writes of rejected candidates.
    a_pad = cap_eff + b
    acc_x = torch.full((n, a_pad + 1), 16, dtype=torch.int32, device=dev)
    acc_y = torch.full((n, a_pad + 1), 16, dtype=torch.int32, device=dev)
    acc_n = torch.zeros((n, a_pad + 1), dtype=torch.float32, device=dev)
    count = torch.zeros((n,), dtype=torch.int64, device=dev)
    count_host = [0] * n
    accept = torch.zeros((n, n_blocks * b), dtype=torch.bool, device=dev)
    # Only EARLIER candidates' paints are read: entry [j, i] kept for j < i.
    tri = torch.triu(torch.ones((b, b), dtype=torch.bool, device=dev), diagonal=1)
    rows = torch.arange(n, device=dev)

    live = [True] * n
    for bi in range(n_blocks):
        # A problem is done from its first all-invalid block on, or at the
        # cap (capped greedy is a prefix of uncapped greedy).
        live = [
            live[r] and bool(block_live[r, bi]) and count_host[r] < cap_eff
            for r in range(n)
        ]
        if not any(live):
            break
        live_t = torch.tensor(live, device=dev)
        bcx, bcy = cx_b[:, bi], cy_b[:, bi]
        bnsc = nsc1_b[:, bi]
        bval = valid_b[:, bi] & live_t[:, None]

        # Pre-block occupancy at each candidate's cell. Empty list slots
        # have nsc 0 and paint exactly 0.
        n_acc = max(count_host)
        if n_acc:
            base = _pair_paint(
                acc_x[:, :n_acc], acc_y[:, :n_acc], acc_n[:, :n_acc], bcx, bcy
            ).sum(dim=1, dtype=torch.int32)
        else:
            base = torch.zeros((n, b), dtype=torch.int32, device=dev)

        # Interval-bound fixpoint: resolve candidates whose lower (accepted
        # predecessors) and upper (+ undecided) readings agree. Sums of at
        # most 256 paints <= 253 are exact in f32.
        m = torch.where(tri, _pair_paint(bcx, bcy, bnsc, bcx, bcy), 0).to(torch.float32)
        acc = torch.zeros((n, b), dtype=torch.bool, device=dev)
        und = bval
        while bool(und.any()):
            bounds = torch.stack([acc, acc | und], dim=1).to(torch.float32)
            s = torch.bmm(bounds, m).to(torch.int32)  # (n, 2, b)
            lo, hi = torch.clamp(base[:, None] + s, max=255).to(torch.float32).unbind(1)
            acc_new = und & ~(bnsc < hi)
            rej_new = und & (bnsc < lo)
            acc = acc | acc_new
            und = und & ~(acc_new | rej_new)

        # Append this block's accepted candidates to each problem's list.
        pos = count[:, None] + acc.to(torch.int64).cumsum(dim=1) - 1
        tgt = torch.where(acc, pos, torch.full_like(pos, a_pad))
        acc_x[rows[:, None], tgt] = bcx
        acc_y[rows[:, None], tgt] = bcy
        acc_n[rows[:, None], tgt] = bnsc
        count = count + acc.sum(dim=1)
        count_host = count.tolist()
        accept[:, bi * b : (bi + 1) * b] = acc

    accept = accept[:, :k]
    # Acceptance cap: capped greedy == first-cap prefix of the uncapped list.
    return accept & (accept.to(torch.int32).cumsum(dim=1) <= max_num_kpt)


def enforce_uniformity_scan_plain(xs, ys, scores, valid, *, radius: float, max_num_kpt: int,
                                  window: int = WINDOW) -> torch.Tensor:
    """Kernel ``enforce_uniformity``'s rounds in torch, every problem of
    the (N, K) batch advancing together: from each problem's cursor, a
    window of ``window`` candidates is tested against the per-candidate
    occupancy; the first that passes is accepted and paints every later
    candidate in its 31x31 patch (saturating at 255), and the cursor moves
    past it; a window with none moves the cursor by ``window``. A problem
    stops at its cap or at K."""
    n, k = xs.shape
    dev = xs.device
    nsc1, cx, cy = _cells(xs, ys, scores, valid, radius)
    cap = min(max_num_kpt, k)
    lut = torch.from_numpy(radial_lut()).reshape(-1).to(dev)
    occ = torch.zeros((n, k), dtype=torch.int32, device=dev)
    accept = torch.zeros((n, k), dtype=torch.bool, device=dev)
    cursor = torch.zeros((n,), dtype=torch.int64, device=dev)
    n_acc = torch.zeros((n,), dtype=torch.int64, device=dev)
    rows = torch.arange(n, device=dev)
    lanes = torch.arange(window, device=dev)
    later = torch.arange(k, device=dev)
    while True:
        live = (cursor < k) & (n_acc < cap)
        if not bool(live.any()):
            break
        i = cursor[:, None] + lanes[None, :]
        inside = (i < k) & live[:, None]
        ic = i.clamp(max=k - 1)
        ok = inside & valid.gather(1, ic) & ~(nsc1.gather(1, ic) < occ.gather(1, ic).to(torch.float32))
        hit = ok.any(dim=1)
        j = cursor + ok.to(torch.int8).argmax(dim=1)  # the first that passes
        jc = j.clamp(max=k - 1)
        accept[rows[hit], j[hit]] = True
        pn = (0.99 * nsc1[rows, jc]).to(torch.float32)
        dx = cx - cx[rows, jc][:, None] + 15
        dy = cy - cy[rows, jc][:, None] + 15
        near = (hit[:, None] & (later[None, :] > j[:, None])
                & (dx >= 0) & (dx < 31) & (dy >= 0) & (dy < 31))
        tap = (dy.clamp(0, 30) * 31 + dx.clamp(0, 30)).to(torch.int64)
        paint = torch.ceil(lut[tap] * pn[:, None]).to(torch.int32)
        occ = torch.where(near, torch.clamp(occ + paint, max=255), occ)
        n_acc = n_acc + hit.to(torch.int64)
        cursor = torch.where(live, torch.where(hit, j + 1, cursor + window), cursor)
    return accept


def enforce_uniformity_grid_plain(xs, ys, scores, valid, *, rows: int, cols: int,
                                  radius: float, max_num_kpt: int,
                                  window: int = WINDOW) -> torch.Tensor:
    """Kernel ``enforce_uniformity``'s grid route in torch, every problem
    of the (N, K) batch advancing together on its own (rows, cols) layer's
    ``grid_shape`` occupancy grid: from each problem's cursor, a window of
    ``window`` candidates reads the grid at their cells; the first that
    passes is accepted and paints its 31x31 patch (saturating at 255; a
    zero LUT tap paints nothing, and a NaN paint converts to 0 as on the
    card), and the cursor moves past it; a window with none moves the
    cursor by ``window``. A problem stops at its cap or at K."""
    n, k = xs.shape
    dev = xs.device
    nsc1, cx, cy = _cells(xs, ys, scores, valid, radius)
    gh, gw = grid_shape(rows, cols, radius)
    cell = torch.where(valid, cy.clamp(15, gh - 16) * gw + cx.clamp(15, gw - 16), 0).to(torch.int64)
    val = torch.where(valid, nsc1, torch.full_like(nsc1, float("-inf")))
    cap = min(max_num_kpt, k)
    lut = torch.from_numpy(radial_lut()).reshape(-1).to(dev)
    taps = torch.arange(31 * 31, device=dev)
    rel = (taps // 31 - 15) * gw + taps % 31 - 15
    grid = torch.zeros((n, gh * gw), dtype=torch.int32, device=dev)
    accept = torch.zeros((n, k), dtype=torch.bool, device=dev)
    cursor = torch.zeros((n,), dtype=torch.int64, device=dev)
    n_acc = torch.zeros((n,), dtype=torch.int64, device=dev)
    rows_ = torch.arange(n, device=dev)
    lanes = torch.arange(window, device=dev)
    while True:
        live = (cursor < k) & (n_acc < cap)
        if not bool(live.any()):
            break
        i = cursor[:, None] + lanes[None, :]
        inside = (i < k) & live[:, None]
        ic = i.clamp(max=k - 1)
        occ = grid.gather(1, cell.gather(1, ic))
        ok = inside & ~(val.gather(1, ic) < occ.to(torch.float32))
        hit = ok.any(dim=1)
        j = cursor + ok.to(torch.int8).argmax(dim=1)  # the first that passes
        jc = j.clamp(max=k - 1)
        accept[rows_[hit], j[hit]] = True
        centre = torch.where(hit, cell[rows_, jc], 15 * gw + 15)  # a patch inside the grid
        pn = torch.where(hit, 0.99 * val[rows_, jc], 0.0).to(torch.float32)
        paint = torch.ceil(lut[None, :] * pn[:, None])
        paint = torch.where(torch.isnan(paint), 0.0, paint).to(torch.int32)
        idx = centre[:, None] + rel[None, :]
        cur = grid.gather(1, idx)
        grid.scatter_(1, idx, torch.where(hit[:, None] & (lut > 0)[None, :],
                                          torch.clamp(cur + paint, max=255), cur))
        n_acc = n_acc + hit.to(torch.int64)
        cursor = torch.where(live, torch.where(hit, j + 1, cursor + window), cursor)
    return accept


_LUTS: dict = {}  # device -> the LUT on it


def _device_lut(dev: torch.device) -> torch.Tensor:
    """``radial_lut()`` on card ``dev``, built there (float64, then cast to
    float32, as on the host) once, so a launch copies nothing."""
    lut = _LUTS.get(dev)
    if lut is None:
        xs = torch.arange(31, dtype=torch.float64, device=dev)
        d2 = (15.0 - xs[None, :]) ** 2 + (15.0 - xs[:, None]) ** 2
        lut = _LUTS[dev] = torch.clamp(1.0 - d2 / 225.0, min=0.0).to(torch.float32).contiguous()
    return lut


def enforce_uniformity_cuda(problems, *, radius: float, shapes=None, rounds: bool = False,
                            route: str = "auto"):
    """Kernel ``enforce_uniformity``: the accept mask of every problem set,
    ``(xs, ys, scores, valid, max_num_kpt)`` with (N, K) tensors on one
    card, in one launch, with no host sync. ``shapes`` gives each set's
    layer (rows, cols), which the grid route needs (None: the candidates
    route for all); ``launch_staging`` places the grid route's staged
    candidates. ``route="candidates"`` forces the candidates route where
    the wrapper would choose the grid (to time and check it). Returns the
    (N, K) bool masks and, with ``rounds``, the rounds each CTA made (int32, the
    problem sets' rows in order)."""
    problems = list(problems)
    shapes = [None] * len(problems) if shapes is None else list(shapes)
    if len(shapes) != len(problems):
        raise ValueError(f"shapes: expected {len(problems)}, got {len(shapes)}")
    if len(problems) > MAX_LAYERS:  # more layers than a launch takes: one launch each chunk
        outs = [enforce_uniformity_cuda(problems[i:i + MAX_LAYERS], radius=radius,
                                        shapes=shapes[i:i + MAX_LAYERS], rounds=rounds,
                                        route=route)
                for i in range(0, len(problems), MAX_LAYERS)]
        if not rounds:
            return [m for part in outs for m in part]
        return ([m for part, _ in outs for m in part], torch.cat([r for _, r in outs]))
    dev = problems[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"enforce_uniformity_cuda needs CUDA tensors, got {dev}")
    if not radius > 0.0:
        raise ValueError(f"enforce_uniformity_cuda takes a radius above 0, got {radius}")
    staging = launch_staging(problems)
    fields, accepts, keep = [], [], []
    for (xs, ys, scores, valid, max_num_kpt), shape in zip(problems, shapes):
        n, k = xs.shape
        for name, t in (("xs", xs), ("ys", ys), ("scores", scores), ("valid", valid)):
            if t.device != dev or tuple(t.shape) != (n, k):
                raise ValueError(f"{name}: expected ({n}, {k}) on {dev}, got "
                                 f"{tuple(t.shape)} on {t.device}")
        if valid.dtype != torch.bool:
            raise ValueError(f"valid: expected bool, got {valid.dtype}")
        if k >= 2**31:
            raise ValueError("enforce_uniformity takes fewer than 2^31 candidates a problem")
        if scores.dtype not in (torch.int32, torch.float32):
            scores = scores.to(torch.float32)  # _cells' conversion
        xs, ys, scores, valid = (t.contiguous() for t in (xs.to(torch.int32), ys.to(torch.int32),
                                                          scores, valid))
        plan, gh, gw, shared, _ = layer_plan(k, shape, radius, route, staging)
        accept = torch.empty((n, k), dtype=torch.bool, device=dev)
        scratch = (None if shared or k == 0 else
                   torch.empty((n * k * SCRATCH_BYTES_PER_CANDIDATE,), dtype=torch.uint8,
                               device=dev))
        keep += [xs, ys, scores, valid, scratch]  # alive until the launch: the table holds raw pointers
        accepts.append(accept)
        fields += (xs.data_ptr(), ys.data_ptr(), scores.data_ptr(), valid.data_ptr(),
                   accept.data_ptr(), 0 if scratch is None else scratch.data_ptr(), n, k,
                   max(0, min(int(max_num_kpt), k)), int(scores.dtype == torch.int32), gh, gw)
    n_ctas = sum(a.shape[0] for a in accepts if a.shape[1])
    counts = torch.empty((n_ctas,), dtype=torch.int32, device=dev)
    if n_ctas:
        table = (ctypes.c_int64 * len(fields))(*fields)
        _kernels.launch("enforce_uniformity", "enforce_uniformity", dev, table, len(problems),
                        float(np.float32(15.0 / radius)), _device_lut(dev).data_ptr(),
                        counts.data_ptr() if rounds else None)
    return (accepts, counts) if rounds else accepts


def enforce_uniformity_layers(problems, *, radius: float, block: int = 256, shapes=None) -> list:
    """The accept masks of ``(xs, ys, scores, valid, max_num_kpt)`` problem
    sets (a detection's layers, of (rows, cols) ``shapes``) on one device:
    one kernel launch for all of them for CUDA tensors (``block`` unread),
    the blocked plain version set by set for CPU tensors (``shapes``
    unread)."""
    problems = list(problems)
    if problems[0][0].device.type != "cpu":
        return enforce_uniformity_cuda(problems, radius=radius, shapes=shapes)
    return [enforce_uniformity_plain(xs, ys, scores, valid, radius=radius,
                                     max_num_kpt=cap, block=block)
            for xs, ys, scores, valid, cap in problems]


def enforce_uniformity(xs, ys, scores, valid, *, radius: float, max_num_kpt: int,
                       block: int = 256, shape=None) -> torch.Tensor:
    """Greedy uniformity mask over score-descending (N, K) candidates of a
    (rows, cols) ``shape`` layer: the kernel for CUDA tensors, the blocked
    plain version for CPU tensors."""
    return enforce_uniformity_layers([(xs, ys, scores, valid, max_num_kpt)], radius=radius,
                                     block=block, shapes=[shape])[0]


def enforce_uniformity_sequential(
    xs, ys, scores, valid, *, rows: int, cols: int, radius: float, max_num_kpt: int
) -> torch.Tensor:
    """One problem (K,), transcribed candidate by candidate from the
    reference's greedy loop (uint8 occupancy grid, 31x31 patch update per
    accepted candidate). The semantics oracle for ``enforce_uniformity``."""
    nsc1, cx, cy = _cells(xs, ys, scores, valid, radius)
    scale_c = int(math.ceil(np.float32(15.0 / radius)))
    occ = np.zeros((rows * scale_c + 32, cols * scale_c + 32), np.int32)
    lut = radial_lut()
    nsc1, cx, cy = nsc1.cpu().numpy(), cx.cpu().numpy(), cy.cpu().numpy()
    ok_in = valid.cpu().numpy()
    accept = np.zeros(xs.shape[0], bool)
    n_acc = 0
    for i in range(xs.shape[0]):
        s0 = np.float32(occ[cy[i], cx[i]])
        if ok_in[i] and n_acc < max_num_kpt and not nsc1[i] < s0:
            paint = np.ceil(lut * (np.float32(0.99) * nsc1[i])).astype(np.int32)
            patch = occ[cy[i] - 15 : cy[i] + 16, cx[i] - 15 : cx[i] + 16]
            patch[...] = np.minimum(patch + paint, 255)
            accept[i] = True
            n_acc += 1
    return torch.from_numpy(accept).to(xs.device)


def bucket_keypoints(valid: torch.Tensor, max_num_kpt: int) -> torch.Tensor:
    """Single-bucket KeyPointBucketing (key-point-bucketing-inl.h:45-112):
    keep the first ``max_num_kpt`` valid candidates in score order."""
    rank = valid.to(torch.int32).cumsum(dim=-1) - 1
    return valid & (rank < max_num_kpt)
