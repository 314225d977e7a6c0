"""Windowed bundle adjustment with Schur-complement reduction (port of
``ba/window.py``).

Keyframe-window Gauss-Newton over poses and landmarks, dense-batched:

* observations are a fixed-capacity structure of arrays (kf_idx, lm_idx,
  uv, valid), ragged windows padded and masked;
* reprojection Jacobians are closed form, batched over all observations;
* the normal equations' blocks are segment sums (``ba/segment.py``) over
  a CSR built once a solve from the valid observations (``ba_plans``),
  which keeps repeated indices and adds each segment in observation order
  on either device: B (K, 6, 6) pose blocks, C (L, 3, 3) landmark blocks,
  E (L, K, 6, 3) on the flat (landmark, keyframe) index;
* the Schur complement S = B - E C^-1 E^T comes from a dense (L, K, 6, 3)
  coupling tensor, is solved densely (6K x 6K) and the landmarks are
  back-substituted in parallel;
* a fixed iteration count as a Python loop, accept/reject by
  ``torch.where``: no host sync inside a solve.

A singular system gives NaN (``se3.solve``), which LM rejects as JAX's
non-finite solve. The segment sums make two runs on the card bitwise
equal; card and CPU still agree to a tolerance, not bit for bit (the
batched products and solves round otherwise on the card).

Gauge: the first ``fix_poses`` poses are held fixed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ethzasl_brisk_tpu_torch.ba.se3 import hat, se3_exp, solve
from ethzasl_brisk_tpu_torch.ba.segment import SegmentPlan, segment_plan, segment_sum
from ethzasl_brisk_tpu_torch.core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class BaProblem:
    """Fixed-capacity BA window. Poses are camera-from-world (R, t):
    x_cam = R x_world + t."""

    r: torch.Tensor          # (K, 3, 3) camera-from-world rotations
    t: torch.Tensor          # (K, 3)
    points: torch.Tensor     # (L, 3) world landmarks
    kf_idx: torch.Tensor     # (O,) int64
    lm_idx: torch.Tensor     # (O,) int64
    uv: torch.Tensor         # (O, 2) observed pixels
    valid: torch.Tensor      # (O,) bool
    fu: torch.Tensor         # () intrinsics, the poses' dtype
    fv: torch.Tensor
    cu: torch.Tensor
    cv: torch.Tensor

    @staticmethod
    def from_numpy(arrays, device: str | torch.device = "cuda") -> "BaProblem":
        """A problem from host arrays keyed by field name (``np.asarray`` of
        each field of the JAX ``BaProblem``); indices become int64."""
        dev = resolve_device(device)
        out = {}
        for f in dataclasses.fields(BaProblem):
            a = np.asarray(arrays[f.name])
            if f.name in ("kf_idx", "lm_idx"):
                a = a.astype(np.int64)
            out[f.name] = torch.from_numpy(np.array(a)).to(dev)
        return BaProblem(**out)


def _where_problem(accept: torch.Tensor, new: BaProblem, old: BaProblem) -> BaProblem:
    return BaProblem(**{
        f.name: torch.where(accept, getattr(new, f.name), getattr(old, f.name))
        for f in dataclasses.fields(BaProblem)
    })


def _residual_and_jacobians(p: BaProblem):
    """Batched residuals + closed-form Jacobians.

    Returns (res (O, 2), J_pose (O, 2, 6), J_point (O, 2, 3), w (O,)).
    Pose Jacobian is wrt a LEFT-multiplied se(3) increment on
    camera-from-world: T <- exp(xi) o T.
    """
    rk = p.r[p.kf_idx]          # (O, 3, 3)
    tk = p.t[p.kf_idx]          # (O, 3)
    x_w = p.points[p.lm_idx]    # (O, 3)
    x_c = torch.einsum("oij,oj->oi", rk, x_w) + tk
    z = x_c[:, 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    iz = 1.0 / z_safe
    u = p.fu * x_c[:, 0] * iz + p.cu
    v = p.fv * x_c[:, 1] * iz + p.cv
    res = torch.stack([u, v], -1) - p.uv

    # d(pixel)/d(x_c).
    iz2 = iz * iz
    zeros = torch.zeros_like(iz)
    j_proj = torch.stack(
        [
            torch.stack([p.fu * iz, zeros, -p.fu * x_c[:, 0] * iz2], -1),
            torch.stack([zeros, p.fv * iz, -p.fv * x_c[:, 1] * iz2], -1),
        ],
        -2,
    )  # (O, 2, 3)

    # d(x_c)/d(xi): left increment => dx_c = dtheta x x_c + dv.
    eye = torch.eye(3, dtype=x_c.dtype, device=x_c.device).expand(*x_c.shape[:-1], 3, 3)
    j_xc_pose = torch.cat([-hat(x_c), eye], dim=-1)  # (O, 3, 6)
    j_pose = j_proj @ j_xc_pose      # (O, 2, 6)
    j_point = j_proj @ rk            # (O, 2, 3)

    w = p.valid.to(res.dtype) * (z > 0.1).to(res.dtype)
    return res, j_pose, j_point, w


@dataclasses.dataclass(frozen=True)
class BaPlans:
    """The CSRs a solve scatters by: keyframe, landmark and the flat
    (landmark, keyframe) index."""

    kf: SegmentPlan
    lm: SegmentPlan
    lm_kf: SegmentPlan


def ba_plans(kf_idx: torch.Tensor, lm_idx: torch.Tensor, valid: torch.Tensor, k: int,
             n_lm: int) -> BaPlans:
    """Built once a solve: its indices and its ``valid`` mask do not change
    over its iterations. An invalid observation is dropped from every sum
    (its weight is 0, so its terms are zeros, and adding a zero changes no
    nonzero sum: the padded slots of a window, all on keyframe 0 and
    landmark 0, would make those segments thousands of rows long); a
    landmark index outside ``[0, n_lm)`` from the landmark sums."""
    lm_ok = valid & (lm_idx >= 0) & (lm_idx < n_lm)
    return BaPlans(segment_plan(torch.where(valid, kf_idx, -1), k),
                   segment_plan(torch.where(lm_ok, lm_idx, -1), n_lm),
                   segment_plan(torch.where(lm_ok, lm_idx * k + kf_idx, -1), n_lm * k))


def _plans_of(p: BaProblem) -> BaPlans:
    return ba_plans(p.kf_idx, p.lm_idx, p.valid, p.r.shape[0], p.points.shape[0])


def _gauss_newton_step(p: BaProblem, damping, fix_poses: int = 1, huber_delta: float = 0.0,
                       plans: BaPlans | None = None):
    plans = plans or _plans_of(p)
    res, j_po, j_pt, w = _residual_and_jacobians(p)
    if huber_delta > 0.0:
        # IRLS Huber: downweight observations with ||res|| > delta.
        rnorm = torch.sqrt(torch.sum(res * res, -1) + 1e-12)
        w = w * torch.clamp(huber_delta / rnorm, max=1.0)
    k = p.r.shape[0]
    n_lm = p.points.shape[0]
    dt, dev = res.dtype, res.device

    wres = res * w[:, None]
    # Block assembly (segment sums over observations).
    j_po_w = j_po * w[:, None, None]
    b_blocks = segment_sum(torch.einsum("oai,oab->oib", j_po_w, j_po), plans.kf)
    c_blocks = segment_sum(torch.einsum("oai,oab->oib", j_pt * w[:, None, None], j_pt), plans.lm)
    g_pose = segment_sum(torch.einsum("oai,oa->oi", j_po, wres), plans.kf)     # (K, 6)
    g_pt = segment_sum(torch.einsum("oai,oa->oi", j_pt, wres), plans.lm)       # (L, 3)
    e_obs = torch.einsum("oai,oab->oib", j_po_w, j_pt)   # per observation

    # Damp.
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    c_inv = torch.linalg.inv_ex(c_blocks + damping * eye3[None] + 1e-9 * eye3[None])[0]

    # Schur: S = B - sum E C^-1 E^T over landmarks, through a dense
    # (L, K, 6, 3) coupling tensor (windows are small: K ~ 10).
    e_dense = segment_sum(e_obs, plans.lm_kf).reshape(n_lm, k, 6, 3)
    ec = torch.einsum("lkis,lst->lkit", e_dense, c_inv)     # (L, K, 6, 3)
    s_red = torch.einsum("lkit,lmjt->kimj", ec, e_dense)    # (K, 6, K, 6)

    b_kk = torch.zeros((k, k, 6, 6), dtype=dt, device=dev)
    ar = torch.arange(k, device=dev)
    b_kk[ar, ar] = b_blocks + damping * eye6[None]
    s = (b_kk.permute(0, 2, 1, 3) - s_red).reshape(6 * k, 6 * k)

    rhs = (g_pose - torch.einsum("lkit,lt->ki", ec, g_pt)).reshape(6 * k)

    # Gauge fixing: freeze the first fix_poses poses (replace their
    # rows/cols with identity). Monocular windows pass fix_poses=2 to
    # anchor the scale gauge as well as the SE(3) gauge.
    fix = torch.arange(6 * k, device=dev) < 6 * fix_poses
    s = torch.where(fix[:, None] | fix[None, :], torch.zeros((), dtype=dt, device=dev), s)
    s = s + torch.diag(fix.to(dt))
    rhs = torch.where(fix, torch.zeros((), dtype=dt, device=dev), rhs)

    delta_pose = -solve(s, rhs[:, None])[:, 0].reshape(k, 6)

    # Back-substitute landmarks: C dx_l = -g_l - E^T dx_pose.
    et_dx = torch.einsum("lkis,ki->ls", e_dense, delta_pose)
    delta_pt = -torch.einsum("lst,lt->ls", c_inv, g_pt + et_dx)

    # Retract.
    dr, dtr = se3_exp(delta_pose)
    r_new = dr @ p.r
    t_new = torch.einsum("kij,kj->ki", dr, p.t) + dtr
    pts_new = p.points + delta_pt
    cost = torch.sum(wres * res)
    return dataclasses.replace(p, r=r_new, t=t_new, points=pts_new), cost


def solve_window_ba(problem: BaProblem, iterations: int = 10, damping: float = 1e-4,
                    fix_poses: int = 1, huber_delta: float = 0.0):
    """Run fixed-iteration damped Gauss-Newton. Returns (problem, costs)."""
    plans = _plans_of(problem)
    costs = []
    for _ in range(iterations):
        problem, cost = _gauss_newton_step(problem, damping, fix_poses, huber_delta, plans)
        costs.append(cost)
    return problem, _stack(costs, problem)


def _stack(values, p: BaProblem) -> torch.Tensor:
    if not values:
        return torch.zeros((0,), dtype=p.r.dtype, device=p.r.device)
    return torch.stack(values)


def robust_cost(p: BaProblem, huber_delta: float = 0.0) -> torch.Tensor:
    """True robust objective: sum over valid observations of the Huber
    rho of the residual norm (plain squared norm when huber_delta == 0).
    This is what LM accept/reject compares, not the IRLS surrogate
    sum(w * r^2), whose weights change with the iterate."""
    res, _, _, w = _residual_and_jacobians(p)
    s2 = torch.sum(res * res, -1)
    if huber_delta > 0.0:
        s = torch.sqrt(s2 + 1e-12)
        rho = torch.where(s <= huber_delta, s2, huber_delta * (2.0 * s - huber_delta))
    else:
        rho = s2
    return torch.sum(w * rho)


def solve_window_ba_lm(problem: BaProblem, iterations: int = 10, damping: float = 1e-3,
                       fix_poses: int = 1, huber_delta: float = 0.0,
                       lambda_down: float = 1.0 / 3.0, lambda_up: float = 4.0,
                       plans: BaPlans | None = None):
    """Levenberg-Marquardt with step accept/reject.

    Each iteration solves the damped system, re-evaluates the true robust
    cost at the candidate, and accepts only steps that decrease it
    (shrinking lambda); rejected steps keep the iterate and grow lambda.
    The objective is therefore monotonically non-increasing: on degenerate
    geometry the solver stalls at the incumbent instead of diverging.

    Returns (problem, costs, lambdas); costs[i] is the accepted objective
    after iteration i. ``plans`` (``ba_plans``) is built here unless given;
    given plans may drop observations this problem still holds valid only
    if their weight is 0 (the trimmed solver's second stage).
    """
    plans = plans or _plans_of(problem)
    lam = torch.tensor(damping, dtype=problem.r.dtype, device=problem.r.device)
    cost = robust_cost(problem, huber_delta)
    costs, lams = [], []
    for _ in range(iterations):
        cand, _ = _gauss_newton_step(problem, lam, fix_poses, huber_delta, plans)
        cost1 = robust_cost(cand, huber_delta)
        # Reject non-finite candidates outright (singular Schur solve).
        accept = torch.isfinite(cost1) & (cost1 < cost)
        problem = _where_problem(accept, cand, problem)
        cost = torch.where(accept, cost1, cost)
        lam = torch.clamp(torch.where(accept, lam * lambda_down, lam * lambda_up), 1e-10, 1e8)
        costs.append(cost)
        lams.append(lam)
    return problem, _stack(costs, problem), _stack(lams, problem)


def solve_window_ba_trimmed(problem: BaProblem, iterations: int = 12, damping: float = 1e-3,
                            fix_poses: int = 1, huber_delta: float = 0.0,
                            trim_sigma: float = 3.0):
    """Two-stage trimmed LM: solve, reject gross outlier observations,
    re-solve from the ORIGINAL iterate on the trimmed set.

    After a first LM pass, a landmark whose mean residual norm, or an
    observation whose residual norm, exceeds a robust z-score cut (median
    + trim_sigma * 1.4826 * MAD, floored) at the stage-1 solution is
    invalidated, and LM restarts from the original poses and points on the
    surviving set. Returns (problem, costs, n_trimmed).
    """
    half = max(iterations // 2, 1)
    plans = _plans_of(problem)
    stage1, _, _ = solve_window_ba_lm(problem, iterations=half, damping=damping,
                                      fix_poses=fix_poses, huber_delta=huber_delta, plans=plans)
    res, _, _, w = _residual_and_jacobians(stage1)
    rnorm = torch.sqrt(torch.sum(res * res, -1) + 1e-12)

    # Track-level statistic: a landmark on a moving object becomes a
    # phantom point whose observations each keep a moderate residual;
    # the landmark's mean residual separates it.
    lm_sum = segment_sum(rnorm * w, plans.lm)
    lm_cnt = segment_sum(w, plans.lm)
    lm_mean = lm_sum / torch.clamp(lm_cnt, min=1.0)
    observed = lm_cnt > 0

    def med_of(vals, mask):
        v = torch.where(mask, vals, torch.full_like(vals, 1e30))
        n = torch.sum(mask)
        at = torch.clamp(n // 2, 0, v.shape[0] - 1)
        return torch.sort(v).values.index_select(0, at.reshape(1))[0]

    def mad_thr(vals, mask, floor):
        med = med_of(vals, mask)
        mad = med_of(torch.abs(vals - med), mask)
        return med + torch.clamp(trim_sigma * 1.4826 * mad, min=floor)

    lm_keep = lm_mean <= mad_thr(lm_mean, observed, 0.5)
    # Plus a per-observation guard for isolated gross outliers.
    obs_keep = rnorm <= mad_thr(rnorm, w > 0, 1.0)

    keep = problem.valid & lm_keep[problem.lm_idx] & obs_keep
    n_trimmed = torch.sum(problem.valid) - torch.sum(keep)
    # Re-solve from the original iterate with the full iteration budget.
    solved, costs, _ = solve_window_ba_lm(dataclasses.replace(problem, valid=keep),
                                          iterations=iterations, damping=damping,
                                          fix_poses=fix_poses, huber_delta=huber_delta,
                                          plans=plans)
    return solved, costs, n_trimmed
