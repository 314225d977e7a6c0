"""Greedy keypoint uniformity enforcement (port of ``detect/uniformity.py``).

Reference: ``EnforceKeyPointUniformity``
(uniformity-enforcement-inl.h:44-194): a score-sorted greedy pass that
paints a saturating uint8 occupancy grid with a 31x31 radial LUT and
rejects candidates whose cell already exceeds
``sqrt(sqrt(score/max_score)) * 255``.

``enforce_uniformity`` ports the JAX package's blocked, exact formulation
(see that module's docstring): candidates go in blocks of ``block``; a
block's occupancy reading against earlier blocks is a pairwise reduction
against the list of accepted candidates; inside the block, an
interval-bound fixpoint resolves the greedy recurrence. The batch axis is
written out: every problem of the batch advances block by block, and the
Python loops stop when every problem is done. That formulation exists
because scatter is slow on the TPU; a CUDA kernel running the sequential
greedy per (frame, layer) is queued as later work.
"""
from __future__ import annotations

import math

import numpy as np
import torch


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


def enforce_uniformity(
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
