"""Sequence runs of the VO and BA layers: the port's counterparts of
``tools/sequence_eval.py`` and ``tools/kitti_eval.py``.

``run_sequence_eval`` integrates frame-to-frame VO over a sequence and
scores it against ground truth. ``run_keyframed`` is kitti_eval's frame
loop: VO integration, the parallax / min-inlier keyframe rule, epipolar
verification of keyframe matches, a sliding window of keyframes through
``build_ba_problem`` and the ``lm`` / ``trimmed`` / ``gn`` solver, the
trim-fraction gate, the monocular scale-gauge projection, the divergence
gate and the propagation of each window's correction to the trajectory.
Its keywords are kitti_eval's flags, with kitti_eval's defaults, its
checkpoints included (``checkpoint_dir``, ``checkpoint_every``; kitti_eval's
crash-consistent rule, ``utils/checkpoint.py``).

Both run on ``device`` (the card unless ``device="cpu"``): detection,
matching, RANSAC and the BA solve are device tensors; the keyframe rule,
the track chaining, the gates and the pose bookkeeping are host numpy.
Monocular scale is taken from the ground-truth step norms when ground
truth is given (standard monocular-VO evaluation practice).
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ethzasl_brisk_tpu_torch.ba.window import (
    solve_window_ba,
    solve_window_ba_lm,
    solve_window_ba_trimmed,
)
from ethzasl_brisk_tpu_torch.core.device import resolve_device
from ethzasl_brisk_tpu_torch.geometry.cameras import PinholeCamera
from ethzasl_brisk_tpu_torch.match.matcher import match_with_ratio_and_crosscheck
from ethzasl_brisk_tpu_torch.pipeline import BriskFeature
from ethzasl_brisk_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    pack_vo_loop_state,
    unpack_vo_loop_state,
)
from ethzasl_brisk_tpu_torch.vo.evaluate import ate_rmse, rpe
from ethzasl_brisk_tpu_torch.vo.frontend import (
    Draw,
    VoConfig,
    VoFrontend,
    _no_mark,
    integrate,
)
from ethzasl_brisk_tpu_torch.vo.tracks import build_ba_problem

# kitti_eval's flags and their defaults (tools/kitti_eval.py:60-125), less
# its camera (a caller's PinholeCamera) and frame count.
KEYFRAMED_DEFAULTS = dict(
    window=6, kf_parallax=12.0, kf_min_inliers=60, max_keypoints=1024, threshold=30.0,
    no_ba=False, ba_min_track_len=3, ba_max_obs_residual=8.0, ba_solver="trimmed",
    ba_iters=12, ba_max_shift=0.0, ba_huber=3.0, ba_max_trim_frac=0.08,
    no_ba_scale_projection=False, no_refine=False, min_inlier_spread=0.15,
    no_normalize_exposure=False, checkpoint_dir=None, checkpoint_every=10,
)
# The stages ``run_keyframed`` marks, per frame and per window.
FRAME_STAGES = ("detect", "match", "ransac", "refine", "kf_verify")
WINDOW_STAGES = ("build_ba", "ba_solve")


def _generator(generator, draw, device):
    if generator is None and draw is None:
        return torch.Generator(device).manual_seed(0)
    return generator


def run_sequence_eval(frames, camera: PinholeCamera, gt_positions=None,
                      generator: torch.Generator | None = None, draw: Draw | None = None,
                      device: str | torch.device = "cuda") -> dict:
    """sequence_eval's run: ``VoFrontend.run_sequence`` with VoConfig's
    defaults over ``frames``; the poses, the path length and, given
    ground-truth positions, the similarity-aligned ATE RMSE."""
    dev = resolve_device(device)
    feature = BriskFeature(octaves=2, uniformity_radius=0.0, absolute_threshold=30.0,
                           max_candidates=1024, max_keypoints=1024, device=dev)
    vo = VoFrontend(camera=camera, feature=feature, config=VoConfig())
    poses = vo.run_sequence(list(frames), generator=_generator(generator, draw, dev), draw=draw)
    positions = np.stack([p[:3, 3] for p in poses])
    out = dict(poses=np.stack(poses),
               path_length=float(np.linalg.norm(np.diff(positions, axis=0), axis=1).sum()))
    if gt_positions is not None:
        n = min(len(gt_positions), len(positions))
        out["ate_rmse"] = float(ate_rmse(positions[:n], np.asarray(gt_positions)[:n],
                                         with_scale=True))
    return out


def _to_cfw(pose_wfc):
    """world-from-camera 4x4 -> camera-from-world (R, t)."""
    r = pose_wfc[:3, :3].T
    t = -r @ pose_wfc[:3, 3]
    return r, t


def run_keyframed(frames, camera: PinholeCamera, gt_poses=None, *,
                  generator: torch.Generator | None = None, draw: Draw | None = None,
                  device: str | torch.device = "cuda", mark=_no_mark, **flags) -> dict:
    """kitti_eval's keyframed VO + window-BA loop over ``frames`` ((H, W)
    uint8 arrays or tensors).

    ``flags`` are kitti_eval's (``KEYFRAMED_DEFAULTS``). ``gt_poses``
    ((N, 4, 4) world-from-camera) gives the monocular scale and the ATE /
    RPE. The RANSAC samples come from ``draw`` when given, else from
    ``generator`` (one on ``device`` seeded with 0 by default), one draw
    per relative pose, in kitti_eval's order. ``mark(stage)`` is called
    after each stage of ``FRAME_STAGES`` and ``WINDOW_STAGES``.

    With ``checkpoint_dir``, the run resumes from the directory's latest
    checkpoint if it holds one, and saves the loop's state at the top of
    frame ``i`` once ``checkpoint_every`` keyframes have passed since the
    last save: the state then holds every effect of the frames before
    ``i``, their window BA included (kitti_eval's crash-consistent rule,
    ``tools/kitti_eval.py:257-275``). The RANSAC source's state is saved
    with it: the generator's, or ``draw.cursor`` when a draw is given
    (such a draw must replay its samples from its cursor). Beyond
    kitti_eval's fields the state holds the keyframe count and the BA
    rejects, so a resumed run's result equals an uninterrupted run's.

    Returns kitti_eval's result (frames, keyframes, ba_runs, ba_rejects,
    path_length, and with ground truth ate_rmse, rpe_trans_rmse,
    rpe_rot_rmse_deg), the frame-0 capacity certificate ``capacity_ok``
    and the trajectory ``poses`` ((N, 4, 4) world-from-camera).
    """
    unknown = set(flags) - set(KEYFRAMED_DEFAULTS)
    if unknown:
        raise TypeError(f"unknown flags {sorted(unknown)}")
    a = dict(KEYFRAMED_DEFAULTS, **flags)
    if a["ba_solver"] not in ("lm", "trimmed", "gn"):
        raise ValueError(f"ba_solver must be lm, trimmed or gn, not {a['ba_solver']!r}")
    dev = resolve_device(device)
    generator = _generator(generator, draw, dev)
    frames = list(frames)
    feature = BriskFeature(octaves=2, uniformity_radius=0.0, absolute_threshold=a["threshold"],
                           max_candidates=2048, max_keypoints=a["max_keypoints"], device=dev)
    # One-shot capacity certificate on the first frame: silently
    # truncating caps would skew every downstream match and pose.
    _, diag = feature.detect_with_diagnostics(torch.as_tensor(frames[0]))
    capacity_ok = bool(diag.ok)
    if not capacity_ok:
        print(f"WARNING: detector capacity overflow on frame 0 (candidates "
              f"{diag.cand_counts.tolist()} vs caps {diag.cand_caps.tolist()}); weakest "
              "candidates are dropped; raise max_candidates.", file=sys.stderr)

    vo = VoFrontend(camera=camera, feature=feature, config=VoConfig(
        refine_iterations=0 if a["no_refine"] else 10,
        normalize_exposure=not a["no_normalize_exposure"],
        min_inlier_spread=a["min_inlier_spread"],
    ))
    cfg = vo.config
    scale_norms = None
    if gt_poses is not None:
        gt_poses = np.asarray(gt_poses)[: len(frames)]
        gt_pos = gt_poses[:, :3, 3]
        scale_norms = np.linalg.norm(np.diff(gt_pos, axis=0), axis=1)

    poses = [np.eye(4)]                 # world-from-camera per frame
    kf = []                             # keyframe records (a resumed run's: the tail)
    n_kf_total = n_ba_runs = n_ba_rejects = 0
    prev = None
    start_frame = 0
    ckpt = None
    if a["checkpoint_dir"]:
        ckpt = CheckpointManager(a["checkpoint_dir"])
        saved, step = ckpt.restore_latest()
        if saved is not None:
            poses, start_frame, _, prev, kf, n_ba_runs = unpack_vo_loop_state(
                saved, generator=generator, draw=draw, device=dev)
            n_kf_total = int(saved.get("n_kf_total", len(kf)))
            n_ba_rejects = int(saved.get("n_ba_rejects", 0))
            print(f"resumed from step {step}: frame {start_frame}, {len(poses)} poses, "
                  f"{len(kf)} tail keyframes", file=sys.stderr)
    last_saved_kf = n_kf_total
    for i, frame in enumerate(frames):
        if i < start_frame:
            continue
        if (ckpt is not None and n_kf_total - last_saved_kf >= a["checkpoint_every"]
                and prev is not None and kf):
            state = pack_vo_loop_state(
                poses=poses, frame_idx=i, key=_source_state(generator, draw), prev=prev, kf=kf,
                window=a["window"], n_frames=len(frames), n_ba_runs=n_ba_runs)
            state["n_kf_total"] = torch.tensor(n_kf_total, dtype=torch.int32)
            state["n_ba_rejects"] = torch.tensor(n_ba_rejects, dtype=torch.int32)
            ckpt.save(i, state)
            last_saved_kf = n_kf_total
        cur = vo.process_frame(torch.as_tensor(frame))
        mark("detect")
        if prev is not None:
            r, t, _, ok, _ = vo.relative_pose(generator, prev[0], prev[1], cur[0], cur[1],
                                              draw=draw, mark=mark)
            s = 1.0 if scale_norms is None else float(scale_norms[i - 1])
            poses.append(integrate(poses[-1], r, t, s, ok))
        prev = cur

        # --- keyframe decision vs the last keyframe.
        promote = not kf
        pair_match = None
        if kf:
            last = kf[-1]
            # chain_tracks convention: current keypoint k matches the
            # previous keyframe's best[k] (query=current, train=last).
            best, matched = match_with_ratio_and_crosscheck(
                cur[1], last["desc"], cur[0].valid, last["kp"].valid,
                max_distance=cfg.max_hamming, ratio_num=cfg.ratio_num, ratio_den=cfg.ratio_den,
            )
            m = matched.cpu().numpy()
            b = best.cpu().numpy()
            n_m = int(m.sum())
            if n_m >= 8:
                lx = last["kp"].x.cpu().numpy()
                ly = last["kp"].y.cpu().numpy()
                cx = cur[0].x.cpu().numpy()
                cy = cur[0].y.cpu().numpy()
                # parallax: current kpt k matches keyframe kpt b[k].
                sel = np.nonzero(m)[0]
                par = float(np.median(np.hypot(lx[b[sel]] - cx[sel], ly[b[sel]] - cy[sel])))
            else:
                par = np.inf
            promote = (par > a["kf_parallax"]) or (n_m < a["kf_min_inliers"])
            if promote:
                # Epipolar-verify the keyframe matches before they feed BA
                # tracks: descriptor-only matches carry outliers that
                # dominate the window solutions on weakly textured scenes.
                _, _, _, ok_kf, inl_kf = vo.relative_pose(
                    generator, cur[0], cur[1], last["kp"], last["desc"], draw=draw
                )
                m_ver = m & inl_kf.cpu().numpy().astype(bool)
                pair_match = (b, m_ver) if bool(ok_kf) and m_ver.sum() >= 8 else (b, m)
            mark("kf_verify")
        if not promote:
            continue

        kf.append(dict(frame=i, kp=cur[0], desc=cur[1], match_to_prev=pair_match))
        n_kf_total += 1

        # --- window BA over the last W keyframes.
        if a["no_ba"] or n_kf_total < 3:
            continue
        win = kf[-a["window"]:]
        pair_matches = [k["match_to_prev"] for k in win[1:] if k["match_to_prev"] is not None]
        if len(pair_matches) != len(win) - 1:
            continue
        win_frames = [k["frame"] for k in win]
        win_poses = [_to_cfw(poses[f]) for f in win_frames]
        keypoint_xy = [
            np.stack([k["kp"].x.cpu().numpy(), k["kp"].y.cpu().numpy()], 1) for k in win
        ]
        prob = build_ba_problem(
            camera, win_poses, keypoint_xy, pair_matches,
            max_landmarks=1024, max_observations=4096,
            min_track_len=a["ba_min_track_len"], max_obs_residual_px=a["ba_max_obs_residual"],
            device=dev,
        )
        mark("build_ba")
        n_obs = int(prob.valid.sum())
        if n_obs < 30:
            continue
        r_new, t_new, rejected = _solve_window(prob, n_obs, a)
        mark("ba_solve")
        if rejected:
            n_ba_rejects += 1
            continue
        if not (np.isfinite(r_new).all() and np.isfinite(t_new).all()):
            continue
        if not a["no_ba_scale_projection"]:
            t_new = _project_scale(r_new, t_new, win_poses)
        # Divergence gate: reject solutions that move any keyframe center
        # by more than ba_max_shift x the window's median baseline.
        c_old = np.stack([-p[0].T @ p[1] for p in win_poses])
        c_new = np.einsum("kij,kj->ki", -r_new.transpose(0, 2, 1), t_new)
        base = np.linalg.norm(np.diff(c_old, axis=0), axis=1)
        med_base = float(np.median(base)) if len(base) else 0.0
        shift = float(np.linalg.norm(c_new - c_old, axis=1).max())
        if a["ba_max_shift"] > 0 and med_base > 0 and shift > a["ba_max_shift"] * med_base:
            n_ba_rejects += 1
            continue
        n_ba_runs += 1
        _propagate(poses, win_frames, r_new, t_new)

    positions = np.stack([p[:3, 3] for p in poses])
    result = dict(
        frames=len(frames),
        keyframes=n_kf_total,
        ba_runs=n_ba_runs,
        ba_rejects=n_ba_rejects,
        path_length=float(np.linalg.norm(np.diff(positions, axis=0), axis=1).sum()),
    )
    if gt_poses is not None:
        gt_pos = np.stack([p[:3, 3] for p in gt_poses])[: len(positions)]
        result["ate_rmse"] = float(ate_rmse(positions, gt_pos))
        trans_err, rot_err = rpe(np.stack(poses), np.stack(gt_poses)[: len(poses)], delta=1)
        result["rpe_trans_rmse"] = float(trans_err)
        result["rpe_rot_rmse_deg"] = float(rot_err)
    result["capacity_ok"] = capacity_ok
    result["poses"] = np.stack(poses)
    return result


def _source_state(generator, draw) -> torch.Tensor:
    """The RANSAC source's state for a checkpoint: the draw's cursor, or
    the generator's state."""
    if draw is None:
        return generator.get_state()
    if not hasattr(draw, "cursor"):
        raise ValueError("a checkpointed run with a draw needs a draw with a cursor")
    return torch.tensor(int(draw.cursor), dtype=torch.int64)


def _solve_window(prob, n_obs: int, a: dict):
    """The window's solve with kitti_eval's settings (fix_poses=2 anchors
    the SE(3) and the monocular scale gauge on the window's first two
    keyframes): host (R, t) of the solution and whether the trimmed
    solver's trim-fraction gate rejected it."""
    kw = dict(iterations=a["ba_iters"], damping=1e-2, fix_poses=2, huber_delta=a["ba_huber"])
    if a["ba_solver"] == "lm":
        solved = solve_window_ba_lm(prob, **kw)[0]
    elif a["ba_solver"] == "trimmed":
        solved, _, n_trim = solve_window_ba_trimmed(prob, **kw)
        # A high trimmed fraction means a coherent outlier population
        # dominated stage 1: the re-solve is anchored to a biased iterate.
        if n_obs and float(n_trim) / n_obs > a["ba_max_trim_frac"]:
            return None, None, True
    else:
        solved = solve_window_ba(prob, **kw)[0]
    return solved.r.cpu().numpy(), solved.t.cpu().numpy(), False


def _project_scale(r_new, t_new, win_poses):
    """Monocular scale-gauge projection: rescale the solved camera centers
    about the gauge-fixed first keyframe so the median inter-keyframe
    baseline matches the pre-BA window's (window scale is unobservable to
    BA, and a stretch compounds through the correction propagation)."""
    c_new0 = np.einsum("kij,kj->ki", -r_new.transpose(0, 2, 1), t_new)
    c_old0 = np.stack([-p[0].T @ p[1] for p in win_poses])
    bn = np.linalg.norm(np.diff(c_new0, axis=0), axis=1)
    bo = np.linalg.norm(np.diff(c_old0, axis=0), axis=1)
    if np.median(bn) > 1e-12:
        s_proj = float(np.median(bo) / np.median(bn))
        c_proj = c_new0[0] + s_proj * (c_new0 - c_new0[0])
        t_new = -np.einsum("kij,kj->ki", r_new, c_proj)
    return t_new


def _propagate(poses, win_frames, r_new, t_new):
    """Replace the window's keyframe poses and apply each keyframe's rigid
    correction to the frames of its following segment, the newest
    keyframe's to every frame after it (correcting only the keyframes
    leaves the in-between frames on the old trajectory)."""
    old_poses = {f: poses[f].copy() for f in win_frames}
    for j, f in enumerate(win_frames):
        m = np.eye(4)
        m[:3, :3] = r_new[j].T
        m[:3, 3] = -r_new[j].T @ t_new[j]
        poses[f] = m
    for j, f in enumerate(win_frames):
        corr = poses[f] @ np.linalg.inv(old_poses[f])
        seg_end = win_frames[j + 1] if j + 1 < len(win_frames) else len(poses)
        for g in range(f + 1, seg_end):
            poses[g] = corr @ poses[g]
