"""Exact sequential emulation of the reference's lazy score cache (port of
``detect/ast_exact.py``).

The reference's AST detection (brisk-scale-space.cc:92-287) depends on the
candidate order in one place: the IsMax2D tie path (:482-530) reads the
``scores_`` matrix raw, and its content depends on which earlier
GetAgastScore calls wrote which pixels (brisk-layer.cc:118-132).

* Every GetAgastScore(x, y, 1) read returns the dense threshold-1 cache
  value whatever the history, and the IsMax2D neighbour compares
  (threshold = center) do not depend on it either, so every probe and
  refinement value stays vectorized (``detect/ast_scale_space.py``).
* Only the raw tie reads see history. The stored value of pixel q is:
  a corner's seed (never overwritten); for t* > 2, t* once any earlier
  toucher wrote with threshold <= t*, else 0; for 1 <= t* <= 2, what the
  last writer left; 0 for t* == 0 or outside [3, n-4).
* Writes, in program order per layer: the corner seeds; the prefill (the
  previous layer's accepted candidates' GetScoreMaxAbove probes,
  :757-867, over the exact prefix of an early-exit scan, plus the 3x3
  around the scan maximum when it completed); then per candidate in
  row-major order the IsMax2D neighbour queries up to the first failing
  compare, and, when IsMax2D and the (order-independent) 3-D gates pass,
  the same-layer 3x3 threshold-1 patch (:600-610 / :232-240).

``exact_is2d_layer`` runs the candidates one after another over the dense
stored map, on the tensors' device, for every frame of the batch at once.
Each step works on its candidate's own 5x5 window of the stored map (every
read and write of the step lies within 2 pixels of the candidate): one
gather, the neighbour writes, the tie reads and the patch writes on the
window, one scatter back.
"""
from __future__ import annotations

import torch

from ethzasl_brisk_tpu_torch.detect.ast_layer import AstLayerMaps
from ethzasl_brisk_tpu_torch.detect.ast_scale_space import (
    K_DROP_THRESHOLD,
    _NEIGH8,
    _TIE_ORDER,
    _bilinear_score,
    _cache_score,
    _gather,
    _inside,
    _scatter_true,
    _score_patch_max,
    _trunc_i32,
    scan_window,
)

f32 = torch.float32
i32 = torch.int32

_WIN = tuple((dy, dx) for dy in range(-2, 3) for dx in range(-2, 3))  # window cells


def _cell(dx: int, dy: int) -> int:
    return (dy + 2) * 5 + (dx + 2)


def above_scan_stamps(
    neighbor: AstLayerMaps,
    xs: torch.Tensor,
    ys: torch.Tensor,
    thr: torch.Tensor,
    mode: str,
    drop: int = K_DROP_THRESHOLD,
):
    """The exact GetScoreMaxAbove touch stamps (brisk-scale-space.cc:757-867).

    Returns (anchor_x, anchor_y, stamp (B, K, 5, 5) bool): the neighbour
    layer's pixels the scan writes at threshold 1, honouring the early
    drop-threshold exit (a probe runs iff no earlier checked probe
    exceeded; its own taps land whatever its outcome), the missing check
    on the bottom row, and the 3x3 around the first strict maximum when the
    scan completes. The stamp is anchored at (anchor - 1): the 3x3 around
    the maximum reaches one cell beyond the scan's taps on every side.
    """
    if mode not in ("above_octave", "above_intra"):
        raise ValueError(mode)
    threshold = (thr + drop).to(f32)
    x_1, x1, y_1, y1 = scan_window(xs, ys, mode)
    ax = _trunc_i32(x_1)   # the anchor is the floor (coordinates are positive)
    ay = _trunc_i32(y_1)
    ix_first = _trunc_i32(x_1 + 1)
    ix_last = _trunc_i32(x1)
    iy_first = _trunc_i32(y_1 + 1)
    iy_last = _trunc_i32(y1)

    grid = torch.zeros(xs.shape + (5, 5), dtype=torch.bool, device=xs.device)
    rr = torch.arange(5, device=xs.device)[:, None]
    cc = torch.arange(5, device=xs.device)[None, :]

    def mark(g, X, Y, active, bilinear):
        """The taps of one probe: (X, Y), and the 2x2 block for a bilinear
        probe (the float overload always reads all 4)."""
        rx = (X - ax + 1)[..., None, None]
        ry = (Y - ay + 1)[..., None, None]
        act = active[..., None, None]
        m = act & (rr == ry) & (cc == rx)
        if bilinear:
            m = m | (act & (rr == ry) & (cc == rx + 1))
            m = m | (act & (rr == ry + 1) & (cc == rx))
            m = m | (act & (rr == ry + 1) & (cc == rx + 1))
        return g | m

    cols = [("f", x_1, None), ("i", ix_first, ix_first <= ix_last), ("f", x1, None)]
    rows = [("f", y_1, None, True), ("i", iy_first, iy_first <= iy_last, True),
            ("f", y1, None, False)]
    exceeded = torch.zeros_like(xs, dtype=torch.bool)
    mx, my = ix_first, iy_first
    best = None
    for ri, (rkind, rval, rex, rcheck) in enumerate(rows):
        for ci, (ckind, cval, cex) in enumerate(cols):
            exists = torch.ones_like(exceeded)
            if cex is not None:
                exists = exists & cex
            if rex is not None:
                exists = exists & rex
            runs = exists & ~exceeded
            if ckind == "i" and rkind == "i":
                v = _cache_score(neighbor, cval, rval).to(f32)
                grid = mark(grid, cval, rval, runs, bilinear=False)
            else:
                xf = cval.to(f32) if ckind == "i" else cval
                yf = rval.to(f32) if rkind == "i" else rval
                v = _bilinear_score(neighbor, xf, yf)
                grid = mark(grid, _trunc_i32(xf), _trunc_i32(yf), runs, bilinear=True)
            px = cval if ckind == "i" else (ix_first if ci == 0 else _trunc_i32(cval))
            py = rval if rkind == "i" else (iy_first if ri == 0 else _trunc_i32(rval))
            if best is None:
                best = v
                if rcheck:
                    exceeded = exceeded | (v > threshold)
                continue
            if rcheck:
                exceeded = exceeded | (runs & (v > threshold))
            upd = runs & (v > best)
            best = torch.where(upd, v, best)
            mx = torch.where(upd, px, mx)
            my = torch.where(upd, py, my)

    # The 3x3 around the maximum, only when the scan completed.
    done = ~exceeded
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            grid = mark(grid, mx + dx, my + dy, done, bilinear=False)
    return ax, ay, grid


def scatter_stamps(layer: AstLayerMaps, ax, ay, stamp, active) -> torch.Tensor:
    """OR the (B, K, 5, 5) stamps of the active candidates into a dense
    (B, h, w) map, inside the writable region [3, n-4) (GetAgastScore's
    guard)."""
    h, w = layer.shape
    d = torch.arange(-1, 4, device=ax.device, dtype=ax.dtype)
    qx = (ax[..., None, None] + d[None, :]).expand(stamp.shape)
    qy = (ay[..., None, None] + d[:, None]).expand(stamp.shape)
    ok = active[..., None, None] & stamp & _inside(qx, qy, h, w, 3)
    b = stamp.shape[0]
    return _scatter_true(layer.cache.shape, torch.clamp(qy, 0, h - 1).reshape(b, -1),
                         torch.clamp(qx, 0, w - 1).reshape(b, -1), ok.reshape(b, -1))


def _window_tables(device):
    """Constant tables over the 25 window cells: the neighbour cells in
    _NEIGH8 order, the tie-sum weights (25, 8) in _TIE_ORDER order, the
    smoothed-center weights of the 8 neighbours, and the patch-write cells
    (3x3; for float_patch the own 2x2 and the 4x4 at -1..2)."""
    nb = torch.tensor([_cell(dx, dy) for dx, dy in _NEIGH8], device=device)
    wgt = ((1, 2, 1), (2, 4, 2), (1, 2, 1))  # brisk-scale-space.cc:505-529
    tie = torch.zeros((25, 8), dtype=i32)
    for j, (tdx, tdy) in enumerate(_TIE_ORDER):
        for r in range(3):
            for c in range(3):
                tie[_cell(tdx + c - 1, tdy + r - 1), j] += wgt[r][c]
    smooth = torch.tensor([2, 2, 2, 2, 1, 1, 1, 1], dtype=i32, device=device)

    def cells(offs):
        m = torch.zeros(25, dtype=torch.bool)
        for dx, dy in offs:
            m[_cell(dx, dy)] = True
        return m.to(device)

    patch3 = cells([(dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    own2 = cells([(0, 0), (1, 0), (0, 1), (1, 1)])
    patch4 = cells([(dx, dy) for dy in (-1, 0, 1, 2) for dx in (-1, 0, 1, 2)])
    return nb, tie.to(device), smooth, patch3, own2, patch4


def exact_is2d_layer(
    layer: AstLayerMaps,
    xs: torch.Tensor,
    ys: torch.Tensor,
    valid: torch.Tensor,
    patch_gate: torch.Tensor,
    prefill: torch.Tensor,
    float_patch: bool = False,
) -> torch.Tensor:
    """Sequential-exact IsMax2D of one layer's (B, K) candidates (row-major
    order per frame): corner seeds, the prefill, per-candidate neighbour-
    query writes up to the first failing compare, raw tie reads, and the
    accepted candidates' same-layer 3x3 threshold-1 writes (gated on the
    3-D checks).

    ``float_patch``: the last-layer and single-layer branches pass float
    keypoint coordinates to GetAgastScore (brisk-scale-space.cc:186-194,
    :227, :233-241), whose bilinear overload touches the 2x2 block
    (x..x+1, y..y+1) (brisk-layer.cc:157-160): the GetScoreMaxBelow
    threshold argument seeds the own 2x2 once IsMax2D passes (whatever the
    3-D gate), and the 3x3 patch gather seeds the 4x4 block (x-1..x+2,
    y-1..y+2) when the gate passes.

    The loop runs to the largest valid count of the batch (one read of the
    counts); later steps would change nothing.
    """
    bsz, h, w = layer.cache.shape
    dev = xs.device
    t_nc = torch.clamp(layer.t_star, min=0)  # the threshold-1 write value
    stored = torch.where(layer.corner, layer.cache,
                         torch.where(prefill, t_nc, 0)).to(i32).reshape(bsz, -1)

    # Order-independent precomputation. A neighbour query
    # GetAgastScore(q, center) returns stored(q) if stored(q) > 2 else
    # (t*(q) if t*(q) >= center else 0); both branches compare alike with
    # center, and so do the tie flags. Only the tie path's smoothed-center
    # sum and its raw reads need the live values.
    center = _gather(layer.cache, ys, xs)
    ndx = torch.tensor([d[0] for d in _NEIGH8], dtype=i32, device=dev)
    ndy = torch.tensor([d[1] for d in _NEIGH8], dtype=i32, device=dev)
    qx = xs[..., None] + ndx
    qy = ys[..., None] + ndy
    inb = _inside(qx, qy, h, w, 3)                     # (B, K, 8)
    t_q = _gather(layer.t_star, qy, qx)
    c8 = center[..., None]
    fresh = torch.where(inb, torch.where(_gather(layer.corner, qy, qx),
                                         _gather(layer.cache, qy, qx),
                                         torch.where(t_q >= c8, t_q, 0)), 0)
    wval = torch.where(t_q >= c8, torch.clamp(t_q, min=0), 0)  # what a query stores
    reject_at = c8 < fresh
    any_rej = reject_at.any(dim=-1)
    first_rej = torch.argmax(reject_at.to(torch.uint8), dim=-1)  # the first failing compare
    fail_j = torch.where(any_rej, first_rej, 8)
    queried = torch.arange(8, device=dev) <= fail_j[..., None]
    do_w = valid[..., None] & queried & inb
    base = valid & ~any_rej
    order = [_NEIGH8.index(d) for d in _TIE_ORDER]
    tie_flags = c8 == fresh[..., order]

    nb, tie_w, smooth_w, patch3, own2, patch4 = _window_tables(dev)
    wdx = torch.tensor([dx for _, dx in _WIN], dtype=i32, device=dev)
    wdy = torch.tensor([dy for dy, _ in _WIN], dtype=i32, device=dev)
    wx = xs[..., None] + wdx
    wy = ys[..., None] + wdy
    widx = torch.clamp(wy, 0, h - 1).to(torch.int64) * w + torch.clamp(wx, 0, w - 1)
    inb_win = _inside(wx, wy, h, w, 3)                  # (B, K, 25)
    tnc_win = _gather(t_nc, wy, wx)
    if float_patch:
        own_pin, gated_pin = own2 & inb_win, patch4 & inb_win
    else:
        own_pin, gated_pin = torch.zeros_like(inb_win), patch3 & inb_win
    center4 = 4 * center
    nb_idx = nb.expand(bsz, 8)

    n_steps = int(valid.sum(dim=1).max()) if valid.numel() else 0
    is2d = torch.zeros_like(valid)
    out = []
    for c in range(n_steps):
        idx = widx[:, c]
        win = torch.gather(stored, 1, idx)
        # The neighbour-query writes, up to the first failing compare.
        old = win[:, nb]
        new = torch.where(do_w[:, c] & (old <= 2), wval[:, c], old)
        win = win.scatter(1, nb_idx, new)
        # The live query values: stored > 2 returns the stored history
        # (brisk-layer.cc:124-125), else the fresh recompute.
        s_live = torch.where(inb[:, c] & (old > 2), old, fresh[:, c])
        smoothed_center = center4[:, c] + (s_live * smooth_w).sum(dim=1)
        # The tie path: raw 3x3 sums around each tied neighbour.
        other = (win[:, :, None] * tie_w).sum(dim=1)
        tie_rej = (tie_flags[:, c] & (other > smoothed_center[:, None])).any(dim=1)
        ok = base[:, c] & ~tie_rej
        # The same-layer threshold-1 writes.
        pin = (own_pin[:, c] & ok[:, None]) | (gated_pin[:, c] & (ok & patch_gate[:, c])[:, None])
        win = torch.where(pin & (win <= 2), tnc_win[:, c], win)
        stored.scatter_(1, idx, win)
        out.append(ok)
    if out:
        is2d[:, :n_steps] = torch.stack(out, dim=1)
    return is2d


def exact_is2d_layers(layers: list[AstLayerMaps], cand,
                      drop: int = K_DROP_THRESHOLD) -> list[torch.Tensor]:
    """The ``exact`` model's IsMax2D masks of every layer: per layer, the
    order-independent 3-D gates feed the same-layer 3x3 write condition,
    and the accepted candidates' exact above-scan stamps prefill the next
    layer. ``drop`` is the scans' drop threshold (0 for the v1 engine)."""
    n_layers = len(layers)
    prefill = torch.zeros(layers[0].cache.shape, dtype=torch.bool, device=layers[0].cache.device)
    out = []
    for i in range(n_layers):
        xs, ys, valid = cand[i]
        center = _gather(layers[i].cache, ys, xs)
        mode_a = "above_octave" if i % 2 == 0 else "above_intra"
        mode_b = "below_octave" if i % 2 == 0 else "below_intra"
        if n_layers == 1:
            gate = torch.ones_like(valid)
        elif i == n_layers - 1:
            gate = _score_patch_max(layers[i - 1], xs, ys, center, mode_b, drop)[0]
        else:
            gate = _score_patch_max(layers[i + 1], xs, ys, center, mode_a, drop)[0]
            if i > 0:  # layer 0's below guess (AGAST 5/8) never rejects
                gate = gate & _score_patch_max(layers[i - 1], xs, ys, center, mode_b, drop)[0]
        is2d = exact_is2d_layer(layers[i], xs, ys, valid, gate, prefill,
                                float_patch=(i == n_layers - 1))
        out.append(is2d)
        if i + 1 < n_layers:
            ax, ay, stamp = above_scan_stamps(layers[i + 1], xs, ys, center, mode_a, drop)
            prefill = scatter_stamps(layers[i + 1], ax, ay, stamp, valid & is2d)
    return out
