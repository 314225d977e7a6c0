"""Batched RANSAC for homography and essential-matrix estimation (port of
``geometry/ransac.py``).

Every hypothesis is drawn, fitted and scored in one batched pass: the
minimal samples are one (n_hypotheses, k) index tensor, the fits are
batched SVDs over the hypothesis axis and inlier counting is one (H, N)
comparison. The 8-point hypotheses' null vectors are the one exception
to running where the points lie: they run on the host's LAPACK on every
device (``_svd`` with ``host``), because on a weak pair cuSOLVER's and
LAPACK's float32 null vectors lead to different hypotheses, and so to
another pose on the card than on the CPU (``vo.synthetic --stress``, step
11; ``tests/test_torch_gpu.py`` prints each SVD site's part). That step is
the only host sync.

Where the JAX functions take a PRNG key, these take a ``torch.Generator``
on the points' device, and an optional ``samples`` tensor that replaces
the draw (how tests replay JAX's own draws). JAX's float width follows its
global x64 flag; here a ``dtype`` keyword does (float32 by default).

A sample that repeats an index (the draw is with replacement, as JAX's)
has no unique null vector; each LAPACK picks its own, so such hypotheses
agree with JAX's only in where they lead when they do not win.
"""
from __future__ import annotations

import math

import torch

from ethzasl_brisk_tpu_torch.ba.se3 import hat, so3_exp, solve


def sample_indices(u: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(n_hyp, k) indices from uniforms ``u`` in [0, 1): each one uniform
    over the points whose weight is set, with replacement. When none is
    set, every index is 0, as JAX's draw gives: its logits are then -1e30
    everywhere, which swallow the Gumbel noise, so its argmax takes the
    first point. Integer inverse-CDF, so a given ``u`` gives the same
    indices on every device, and no host sync."""
    w = weights.to(torch.int64)
    first = torch.zeros_like(w)
    first[0] = 1
    w = torch.where(w.sum() > 0, w, first)
    cdf = torch.cumsum(w, 0)
    target = torch.floor(u.to(torch.float64) * cdf[-1].to(torch.float64)).to(torch.int64)
    return torch.searchsorted(cdf, target.reshape(-1), right=True).reshape(u.shape)


def draw_samples(generator: torch.Generator, n_hyp: int, k: int,
                 weights: torch.Tensor) -> torch.Tensor:
    """The default draw: uniforms from ``generator`` (on the weights'
    device) through ``sample_indices``."""
    u = torch.rand((n_hyp, k), generator=generator, dtype=torch.float64,
                   device=weights.device)
    return sample_indices(u, weights)


def _normalize_points(pts):
    """Hartley normalization: zero-mean, sqrt(2) RMS. Returns (pts_n, T)."""
    mean = pts.mean(dim=-2, keepdim=True)
    d = torch.sqrt(((pts - mean) ** 2).sum(-1)).mean(-1)
    s = math.sqrt(2.0) / torch.where(d == 0, torch.ones_like(d), d)
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    mx = -s * mean[..., 0, 0]
    my = -s * mean[..., 0, 1]
    t = torch.stack([torch.stack([s, zero, mx], -1),
                     torch.stack([zero, s, my], -1),
                     torch.stack([zero, zero, one], -1)], -2)
    pts_n = pts * s[..., None, None] - torch.stack(
        [s * mean[..., 0, 0], s * mean[..., 0, 1]], -1
    )[..., None, :]
    return pts_n, t


def _dlt_rows(p1n, p2n):
    x, y = p1n[..., 0], p1n[..., 1]
    u, v = p2n[..., 0], p2n[..., 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    row1 = torch.stack([-x, -y, -ones, zeros, zeros, zeros, u * x, u * y, u], -1)
    row2 = torch.stack([zeros, zeros, zeros, -x, -y, -ones, v * x, v * y, v], -1)
    return row1, row2


def _svd(a, full_matrices: bool = True, host: bool = False):
    """``torch.linalg.svd`` of ``a`` where it lies or, with ``host``, on
    the host's LAPACK with the factors moved back to ``a``'s device (so the
    card takes the CPU's singular vectors)."""
    if not host or a.device.type == "cpu":
        return torch.linalg.svd(a, full_matrices=full_matrices)
    return tuple(f.to(a.device) for f in torch.linalg.svd(a.cpu(), full_matrices=full_matrices))


def _null_vector(a, host: bool = False):
    """The last right singular vector of each (..., M, 9) system (on the
    host's LAPACK with ``host``)."""
    return _svd(a, full_matrices=True, host=host)[2][..., -1, :]


def _h_normalize(h):
    h22 = h[..., 2:3, 2:3]
    return h / torch.where(torch.abs(h22) < 1e-12, torch.ones_like(h22), h22)


def fit_homography_dlt(p1, p2):
    """Batched DLT: p1, p2 (..., K>=4, 2) -> (..., 3, 3) with H p1 ~ p2."""
    p1n, t1 = _normalize_points(p1)
    p2n, t2 = _normalize_points(p2)
    row1, row2 = _dlt_rows(p1n, p2n)
    a = torch.cat([row1, row2], dim=-2)  # (..., 2K, 9)
    h = _null_vector(a).reshape(*a.shape[:-2], 3, 3)
    return _h_normalize(solve(t2, h @ t1))


def homography_reproj_error(h, p1, p2):
    """Squared reprojection error |H p1 - p2|^2, (..., N)."""
    x = p1[..., 0]
    y = p1[..., 1]
    w = h[..., 2, 0, None] * x + h[..., 2, 1, None] * y + h[..., 2, 2, None]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    u = (h[..., 0, 0, None] * x + h[..., 0, 1, None] * y + h[..., 0, 2, None]) / w
    v = (h[..., 1, 0, None] * x + h[..., 1, 1, None] * y + h[..., 1, 2, None]) / w
    return (u - p2[..., 0]) ** 2 + (v - p2[..., 1]) ** 2


def _pick(x, i):
    """``x[i]`` for a 0-d index tensor without a host sync (a 0-d index
    is read back as a Python int)."""
    return x.index_select(0, i.reshape(1))[0]


def ransac_homography(
    generator: torch.Generator | None,
    p1: torch.Tensor,       # (N, 2)
    p2: torch.Tensor,       # (N, 2)
    valid: torch.Tensor,    # (N,) bool
    threshold: float = 3.0,
    n_hypotheses: int = 256,
    samples: torch.Tensor | None = None,
    dtype: torch.dtype = torch.float32,
):
    """Batched-hypothesis RANSAC homography.

    Returns (H (3,3), inlier_mask (N,), n_inliers). Refits on the best
    hypothesis's inliers with weighted DLT (invalid rows zero-weighted).
    ``samples`` (n_hypotheses, 4) int64 replaces the draw from ``generator``.
    """
    p1 = p1.to(dtype)
    p2 = p2.to(dtype)
    idx = samples if samples is not None else draw_samples(generator, n_hypotheses, 4, valid)
    h = fit_homography_dlt(p1[idx], p2[idx])  # (H, 3, 3)
    err = homography_reproj_error(h, p1[None], p2[None])  # (H, N)
    inl = (err < threshold * threshold) & valid[None]
    scores = inl.sum(dim=1)
    best = torch.argmax(scores)  # the first maximum, as jnp.argmax
    h_best = _pick(h, best)
    inlier_mask = _pick(inl, best)

    # Refit with inliers via zero-weighting (static shapes).
    w = inlier_mask.to(dtype)
    h_refit = _weighted_dlt(p1, p2, w)
    err_r = homography_reproj_error(h_refit[None], p1[None], p2[None])[0]
    inl_r = (err_r < threshold * threshold) & valid
    better = inl_r.sum() >= inlier_mask.sum()
    h_out = torch.where(better, h_refit, h_best)
    mask_out = torch.where(better, inl_r, inlier_mask)
    return h_out, mask_out, mask_out.sum()


def _weighted_dlt(p1, p2, w):
    p1n, t1 = _normalize_points(p1)
    p2n, t2 = _normalize_points(p2)
    row1, row2 = _dlt_rows(p1n, p2n)
    a = torch.cat([row1 * w[:, None], row2 * w[:, None]], dim=0)
    h = _null_vector(a).reshape(3, 3)
    return _h_normalize(solve(t2, h @ t1))


def _essential_rows(r1, r2):
    x1, y1 = r1[..., 0], r1[..., 1]
    x2, y2 = r2[..., 0], r2[..., 1]
    return torch.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, torch.ones_like(x1)], -1
    )


def _project_essential(e):
    """Project to the essential manifold: singular values (s, s, 0)."""
    u, s, vh = _svd(e)
    s_mean = (s[..., 0] + s[..., 1]) * 0.5
    s_new = torch.stack([s_mean, s_mean, torch.zeros_like(s_mean)], -1)
    return u @ (s_new[..., None] * vh)


def fit_essential_8pt(r1, r2):
    """Batched 8-point: r1, r2 (..., K>=8, 2) normalized image coords.

    Returns (..., 3, 3) essential matrices with the rank-2, equal-singular
    -value constraint projected.
    """
    a = _essential_rows(r1, r2)  # (..., K, 9)
    e = _null_vector(a, host=True).reshape(*a.shape[:-2], 3, 3)
    return _project_essential(e)


def sampson_error(e, r1, r2):
    """Squared Sampson distance, (..., N)."""
    x1 = torch.cat([r1, torch.ones_like(r1[..., :1])], -1)
    x2 = torch.cat([r2, torch.ones_like(r2[..., :1])], -1)
    ex1 = torch.einsum("...ij,...nj->...ni", e, x1)
    etx2 = torch.einsum("...ji,...nj->...ni", e, x2)
    num = torch.einsum("...ni,...ni->...n", x2, ex1) ** 2
    den = ex1[..., 0] ** 2 + ex1[..., 1] ** 2 + etx2[..., 0] ** 2 + etx2[..., 1] ** 2
    return num / torch.where(den < 1e-12, torch.full_like(den, 1e-12), den)


def ransac_essential(
    generator: torch.Generator | None,
    r1: torch.Tensor,       # (N, 2) normalized image coords, frame 1
    r2: torch.Tensor,       # (N, 2) frame 2
    valid: torch.Tensor,    # (N,)
    threshold: float = 1e-3,
    n_hypotheses: int = 512,
    samples: torch.Tensor | None = None,
    dtype: torch.dtype = torch.float32,
):
    """Batched 8-point RANSAC. Returns (E, inlier_mask, n_inliers).
    ``samples`` (n_hypotheses, 8) int64 replaces the draw from ``generator``."""
    r1 = r1.to(dtype)
    r2 = r2.to(dtype)
    idx = samples if samples is not None else draw_samples(generator, n_hypotheses, 8, valid)
    e = fit_essential_8pt(r1[idx], r2[idx])
    err = sampson_error(e, r1[None], r2[None])
    inl = (err < threshold) & valid[None]
    scores = inl.sum(dim=1)
    best = torch.argmax(scores)  # the first maximum, as jnp.argmax
    e_best = _pick(e, best)
    mask = _pick(inl, best)

    # Refit on the best inlier set (zero-weighted rows).
    a = _essential_rows(r1, r2) * mask.to(dtype)[:, None]
    e_r = _project_essential(_null_vector(a).reshape(3, 3))
    err_r = sampson_error(e_r[None], r1[None], r2[None])[0]
    inl_r = (err_r < threshold) & valid
    better = inl_r.sum() >= mask.sum()
    e_out = torch.where(better, e_r, e_best)
    mask_out = torch.where(better, inl_r, mask)
    return e_out, mask_out, mask_out.sum()


def decompose_essential(e, r1, r2, valid):
    """E -> (R, t) with cheirality voting over the 4 candidates.

    Returns (R (3,3), t (3,) unit, n_in_front).
    """
    u, _, vh = _svd(e)
    # Ensure proper rotations.
    u = u * torch.sign(torch.linalg.det(u))
    vh = vh * torch.sign(torch.linalg.det(vh))[..., None]
    w = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=e.dtype, device=e.device)
    r_a = u @ w @ vh
    r_b = u @ w.T @ vh
    t_u = u[..., :, 2]
    x1 = torch.cat([r1, torch.ones_like(r1[..., :1])], -1)
    x2 = torch.cat([r2, torch.ones_like(r2[..., :1])], -1)

    def count_front(r, t):
        # Triangulate (midpoint-free: depth signs from two-view geometry).
        rx1 = torch.einsum("ij,nj->ni", r, x1)
        # Solve for depths: z2 * x2 = z1 * R x1 + t (least squares 2x2).
        a11 = torch.sum(rx1 * rx1, -1)
        a12 = -torch.sum(rx1 * x2, -1)
        a22 = torch.sum(x2 * x2, -1)
        b1 = -torch.sum(rx1 * t, -1)
        b2 = torch.sum(x2 * t, -1)
        det = a11 * a22 - a12 * a12
        det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
        z1 = (a22 * b1 - a12 * b2) / det
        z2 = (a11 * b2 - a12 * b1) / det
        return torch.sum((z1 > 0) & (z2 > 0) & valid)

    cands = [(r_a, t_u), (r_a, -t_u), (r_b, t_u), (r_b, -t_u)]
    counts = torch.stack([count_front(r, t) for r, t in cands])
    best = torch.argmax(counts)
    rs = torch.stack([c[0] for c in cands])
    ts = torch.stack([c[1] for c in cands])
    return _pick(rs, best), _pick(ts, best), _pick(counts, best)


def refine_relative_pose(
    r0: torch.Tensor,        # (3, 3) initial rotation (p2 = R p1 + t)
    t0: torch.Tensor,        # (3,) initial unit translation
    r1_pts: torch.Tensor,    # (N, 2) normalized coords frame 1
    r2_pts: torch.Tensor,    # (N, 2) frame 2
    weights: torch.Tensor,   # (N,) 0/1 inlier weights
    iterations: int = 10,
    damping: float = 1e-6,
):
    """Gauss-Newton refinement of (R, t) on the Sampson error.

    Tightens the 8-point estimate (the monocular scale stays fixed by
    renormalizing t each step). The Jacobian is JAX's forward mode
    (``jacfwd``) of the residuals at a zero increment, carried by hand: the
    six tangents go through the same chain in one batched pass, where
    ``torch.func.jvp`` spent ~6 ms of host time a tangent. A step is kept
    only where it lowers the cost, chosen with ``torch.where``. Returns
    (R, t_unit, final_cost).
    """
    dt = r1_pts.dtype
    dev = r1_pts.device
    x1 = torch.cat([r1_pts, torch.ones_like(r1_pts[:, :1])], -1)
    x2 = torch.cat([r2_pts, torch.ones_like(r2_pts[:, :1])], -1)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    hat_e = hat(eye3)  # (3, 3, 3): hat of each unit axis

    def residuals(r, t_base, with_jacobian=False):
        """Residuals at (R, t_base / |t_base|) and, with ``with_jacobian``,
        their derivative along the increment (omega, v) of
        R <- exp(omega) R, t <- (t_base + v) / |t_base + v| at zero."""
        n = torch.clamp(torch.linalg.vector_norm(t_base), min=1e-9)
        t_unit = t_base / n
        e = hat(t_unit[None])[0] @ r
        ex1 = x1 @ e.T
        etx2 = x2 @ e
        num = torch.sum(x2 * ex1, -1)
        den = ex1[:, 0] ** 2 + ex1[:, 1] ** 2 + etx2[:, 0] ** 2 + etx2[:, 1] ** 2
        q = torch.sqrt(torch.clamp(den, min=1e-12))
        res = num / q * weights
        if not with_jacobian:
            return res
        # Tangents of R (exp's derivative at zero is hat) and of t / |t|.
        d_t = (eye3 - t_base[:, None] * t_base[None, :] / (n * n)) / n  # row j: d/d v_j
        d_e = torch.cat([hat(t_unit[None])[0] @ hat_e @ r,             # omega
                         hat(d_t) @ r])                                  # v
        d_ex1 = torch.einsum("nj,kij->kni", x1, d_e)                    # (6, N, 3)
        d_etx2 = torch.einsum("ni,kij->knj", x2, d_e)
        d_num = torch.sum(x2 * d_ex1, -1)                               # (6, N)
        d_den = 2.0 * (ex1[:, 0] * d_ex1[..., 0] + ex1[:, 1] * d_ex1[..., 1]
                       + etx2[:, 0] * d_etx2[..., 0] + etx2[:, 1] * d_etx2[..., 1])
        d_q = torch.where(den > 1e-12, d_den / (2.0 * q), torch.zeros_like(d_den))
        d_res = (d_num / q - num * d_q / (q * q)) * weights
        return res, d_res.T                                             # (N,), (N, 6)

    r, t = r0, t0
    cost = torch.sum(residuals(r, t) ** 2)
    for _ in range(iterations):
        res, jac = residuals(r, t, with_jacobian=True)
        h = jac.T @ jac + damping * eye6
        g = jac.T @ res
        delta = -solve(h, g[:, None])[:, 0]
        dr = so3_exp(delta[:3][None])[0]
        r_new = dr @ r
        t_new = t + delta[3:]
        t_new = t_new / torch.clamp(torch.linalg.vector_norm(t_new), min=1e-9)
        new_cost = torch.sum(residuals(r_new, t_new) ** 2)
        better = new_cost < cost
        r = torch.where(better, r_new, r)
        t = torch.where(better, t_new, t)
        cost = torch.where(better, new_cost, cost)
    return r, t, cost
