"""Trajectory evaluation: ATE/RPE + TUM/KITTI pose-format IO (the port's own
copy of ``vo/evaluate.py``, numpy only).

Parsers for the two standard ground-truth formats and the standard
absolute trajectory error (Umeyama/Horn alignment + RMSE) and relative
pose error. ``vo/sequence.py`` wires them to a sequence of frames.
"""
from __future__ import annotations

import numpy as np


def load_tum_trajectory(path: str):
    """TUM format: `timestamp tx ty tz qx qy qz qw` per line.

    Returns (timestamps (N,), positions (N, 3), quaternions (N, 4) xyzw).
    """
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            rows.append(vals[:8])
    arr = np.asarray(rows)
    return arr[:, 0], arr[:, 1:4], arr[:, 4:8]


def load_kitti_trajectory(path: str):
    """KITTI odometry format: 12 floats per line = row-major 3x4 [R|t].

    Returns (N, 4, 4) world-from-camera poses.
    """
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            v = np.asarray([float(x) for x in line.split()]).reshape(3, 4)
            m = np.eye(4)
            m[:3] = v
            rows.append(m)
    return np.stack(rows)


def quat_to_rot(q_xyzw: np.ndarray) -> np.ndarray:
    """(N, 4) xyzw quaternions -> (N, 3, 3)."""
    x, y, z, w = (q_xyzw[:, i] for i in range(4))
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.stack(
        [
            np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                      2 * (x * z + y * w)], -1),
            np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                      2 * (y * z - x * w)], -1),
            np.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                      1 - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )


def umeyama_alignment(est: np.ndarray, gt: np.ndarray, with_scale=True):
    """Least-squares similarity aligning est positions onto gt.

    Returns (s, R, t) with gt ~ s R est + t.
    """
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    e = est - mu_e
    g = gt - mu_g
    cov = g.T @ e / len(est)
    u, d, vt = np.linalg.svd(cov)
    s_mat = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_mat[2, 2] = -1
    r = u @ s_mat @ vt
    if with_scale:
        var_e = (e ** 2).sum() / len(est)
        scale = np.trace(np.diag(d) @ s_mat) / var_e
    else:
        scale = 1.0
    t = mu_g - scale * r @ mu_e
    return scale, r, t


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray,
             with_scale: bool = True) -> float:
    """Absolute trajectory error RMSE after similarity alignment."""
    s, r, t = umeyama_alignment(est_positions, gt_positions, with_scale)
    aligned = (s * (r @ est_positions.T)).T + t
    return float(np.sqrt(((aligned - gt_positions) ** 2).sum(1).mean()))


def rpe(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1):
    """Relative pose error over `delta`-step pairs.

    est_poses/gt_poses: (N, 4, 4) world-from-camera.
    Returns (trans_rmse, rot_rmse_deg).
    """
    t_errs, r_errs = [], []
    for i in range(len(est_poses) - delta):
        de = np.linalg.inv(est_poses[i]) @ est_poses[i + delta]
        dg = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        e = np.linalg.inv(dg) @ de
        t_errs.append(np.linalg.norm(e[:3, 3]))
        cos = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        r_errs.append(np.degrees(np.arccos(cos)))
    return (
        float(np.sqrt(np.mean(np.square(t_errs)))),
        float(np.sqrt(np.mean(np.square(r_errs)))),
    )
