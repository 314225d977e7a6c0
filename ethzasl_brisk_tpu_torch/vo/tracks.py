"""Track building and triangulation: VO matches -> BA windows (port of
``vo/tracks.py``).

Chains pairwise descriptor matches into multi-frame tracks, triangulates
initial landmarks from the first and last observation of each track
(midpoint, two views) and assembles a fixed-capacity ``BaProblem``.

Everything here runs on the host: the track chaining is ragged
bookkeeping over a handful of keyframes, and the triangulation of the
window's tracks runs as float32 torch ops on the CPU, so a window is the
same whichever device solves it. ``build_ba_problem`` hands the finished
problem to ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from ethzasl_brisk_tpu_torch.ba.window import BaProblem
from ethzasl_brisk_tpu_torch.core.device import resolve_device
from ethzasl_brisk_tpu_torch.geometry.cameras import PinholeCamera


def chain_tracks(pair_matches, n_keypoints: int | None):
    """Chain per-pair matches into tracks.

    pair_matches: list over frames 1..F-1 of (best_idx (K,), matched (K,))
      numpy arrays; frame i's keypoint k matches frame i-1's best_idx[k].
    ``n_keypoints`` is unused (the JAX signature's).
    Returns: list of tracks, each a list of (frame_idx, keypoint_idx).
    """
    n_frames = len(pair_matches) + 1
    # track id per (frame, keypoint)
    track_of = [dict() for _ in range(n_frames)]
    tracks: list[list[tuple[int, int]]] = []
    for fi, (best, matched) in enumerate(pair_matches, start=1):
        for k in np.nonzero(matched)[0]:
            prev_k = int(best[k])
            tid = track_of[fi - 1].get(prev_k)
            if tid is None:
                tid = len(tracks)
                tracks.append([(fi - 1, prev_k)])
                track_of[fi - 1][prev_k] = tid
            tracks[tid].append((fi, int(k)))
            track_of[fi][int(k)] = tid
    return [t for t in tracks if len(t) >= 2]


def triangulate_two_view(r_a, t_a, r_b, t_b, ray_a, ray_b):
    """Batched midpoint triangulation in world coords.

    Poses are camera-from-world (x_c = R x_w + t); rays are unit camera-
    frame directions. Returns ((N, 3) points, (N,) valid).
    """
    # Camera centers and world-frame ray directions.
    c_a = -torch.einsum("...ji,...j->...i", r_a, t_a)
    c_b = -torch.einsum("...ji,...j->...i", r_b, t_b)
    d_a = torch.einsum("...ji,...j->...i", r_a, ray_a)
    d_b = torch.einsum("...ji,...j->...i", r_b, ray_b)

    # Solve min || c_a + s d_a - (c_b + u d_b) ||.
    daa = torch.sum(d_a * d_a, -1)
    dbb = torch.sum(d_b * d_b, -1)
    dab = torch.sum(d_a * d_b, -1)
    dc = c_b - c_a
    rhs_a = torch.sum(d_a * dc, -1)
    rhs_b = torch.sum(d_b * dc, -1)
    det = daa * dbb - dab * dab
    det_safe = torch.where(torch.abs(det) < 1e-9, torch.full_like(det, 1e-9), det)
    s = (rhs_a * dbb - rhs_b * dab) / det_safe
    u = (rhs_a * dab - rhs_b * daa) / det_safe
    p = 0.5 * (c_a + s[..., None] * d_a + c_b + u[..., None] * d_b)
    valid = (s > 0) & (u > 0) & (torch.abs(det) > 1e-9)
    return p, valid


def build_ba_problem(
    camera: PinholeCamera,
    poses,                    # list of (R, t) camera-from-world, numpy
    keypoint_xy,              # list over frames of (K, 2) numpy pixels
    pair_matches,             # as for chain_tracks
    max_landmarks: int = 2048,
    max_observations: int = 8192,
    min_track_len: int = 2,
    max_obs_residual_px: float = 0.0,
    device: str | torch.device = "cuda",
) -> BaProblem:
    """Assemble a fixed-capacity BA window from tracked matches, on
    ``device``.

    ``max_obs_residual_px > 0`` enables the pre-BA track gate: each
    observation's reprojection residual of the triangulated landmark
    under the INITIAL poses is computed, observations above the
    threshold (or behind the camera) are invalidated, and a landmark
    keeping fewer than ``min_track_len`` observations is dropped
    entirely. This targets coherently-moving scene content (e.g. an
    occluder crossing the view): such tracks triangulate consistently
    from their endpoints but misfit the middle observations, which a
    per-observation robust loss inside BA cannot tell from pose error.
    """
    dev = resolve_device(device)
    tracks = [
        t for t in chain_tracks(pair_matches, None) if len(t) >= min_track_len
    ][:max_landmarks]

    r_all = np.stack([p[0] for p in poses]).astype(np.float32)
    t_all = np.stack([p[1] for p in poses]).astype(np.float32)

    def intrinsics():
        return {k: torch.tensor(getattr(camera, k), dtype=torch.float32, device=dev)
                for k in ("fu", "fv", "cu", "cv")}

    def on_device(**arrays):
        return BaProblem(**{k: torch.from_numpy(v).to(dev) for k, v in arrays.items()},
                         **intrinsics())

    if not tracks:
        # No usable tracks (e.g. min_track_len filtered everything):
        # return an all-invalid fixed-capacity problem so callers can
        # uniformly check prob.valid.sum().
        return on_device(
            r=r_all, t=t_all,
            points=np.zeros((max_landmarks, 3), np.float32),
            kf_idx=np.zeros((max_observations,), np.int64),
            lm_idx=np.zeros((max_observations,), np.int64),
            uv=np.zeros((max_observations, 2), np.float32),
            valid=np.zeros((max_observations,), bool),
        )

    # Initial landmarks: triangulate first/last observation per track.
    fa = np.array([t[0][0] for t in tracks])
    fb = np.array([t[-1][0] for t in tracks])
    uv_a = np.stack([keypoint_xy[f][k] for (f, k) in (t[0] for t in tracks)])
    uv_b = np.stack([keypoint_xy[f][k] for (f, k) in (t[-1] for t in tracks)])
    ray_a = camera.unproject(torch.from_numpy(uv_a.astype(np.float32)))
    ray_b = camera.unproject(torch.from_numpy(uv_b.astype(np.float32)))
    pts, tri_ok = triangulate_two_view(
        torch.from_numpy(r_all[fa]), torch.from_numpy(t_all[fa]),
        torch.from_numpy(r_all[fb]), torch.from_numpy(t_all[fb]), ray_a, ray_b,
    )
    pts = pts.numpy()
    tri_ok = tri_ok.numpy()

    # Observations.
    kf_idx, lm_idx, uv, valid = [], [], [], []
    for li, tr in enumerate(tracks):
        for (f, k) in tr:
            kf_idx.append(f)
            lm_idx.append(li)
            uv.append(keypoint_xy[f][k])
            valid.append(bool(tri_ok[li]))
    n_obs = len(kf_idx)

    if max_obs_residual_px > 0 and n_obs:
        # Pre-BA residual gate (see docstring): reproject the initial
        # landmarks through the initial poses and drop misfitting
        # observations, then landmarks that fall under min_track_len.
        kf_a = np.asarray(kf_idx)
        lm_a = np.asarray(lm_idx)
        uv_a2 = np.asarray(uv, np.float64)
        p_w = pts[lm_a]
        x_c = (
            np.einsum("nij,nj->ni", r_all[kf_a].astype(np.float64), p_w)
            + t_all[kf_a].astype(np.float64)
        )
        z = x_c[:, 2]
        behind = z <= 1e-6
        z_safe = np.where(behind, 1.0, z)
        u_p = float(camera.fu) * x_c[:, 0] / z_safe + float(camera.cu)
        v_p = float(camera.fv) * x_c[:, 1] / z_safe + float(camera.cv)
        res = np.hypot(u_p - uv_a2[:, 0], v_p - uv_a2[:, 1])
        ok = np.asarray(valid) & ~behind & (res <= max_obs_residual_px)
        # Landmark survives only with >= min_track_len clean obs.
        keep_count = np.bincount(lm_a[ok], minlength=len(pts))
        lm_ok = keep_count >= min_track_len
        valid = list(ok & lm_ok[lm_a])

    def cap(arr, fill, dtype, width=None):
        shape = (max_observations,) if width is None else (max_observations, width)
        out = np.full(shape, fill, dtype)
        arr = np.asarray(arr, dtype)[:max_observations]
        out[: len(arr)] = arr
        return out

    lm_pad = np.zeros((max_landmarks, 3), np.float32)
    lm_pad[: len(pts)] = pts

    return on_device(
        r=r_all, t=t_all, points=lm_pad,
        kf_idx=cap(kf_idx, 0, np.int64),
        lm_idx=cap(lm_idx, 0, np.int64),
        uv=cap(uv, 0.0, np.float32, 2),
        valid=cap(valid, False, bool) & (np.arange(max_observations) < n_obs),
    )
