"""Keyframed VO + window BA over a directory of frames, with ATE/RPE.

    python -m ethzasl_brisk_tpu_torch.vo <frames_dir> --gt poses.txt \\
        [--gt-format kitti|tum] [--fu F --fv F --cu C --cv C]
        [--max-frames N] [--window W] [--kf-parallax PX] [--no-ba]
        [--no-refine] [--checkpoint-dir DIR] [--checkpoint-every N]
        [--device cuda|cpu] [--json]

The port's ``tools/kitti_eval.py``: the same flags and defaults (KITTI
00's camera 0). With ``--checkpoint-dir`` the run resumes from the
directory's latest checkpoint and saves one every ``--checkpoint-every``
keyframes. ``frames_dir`` holds sorted .pgm
(or .png/.jpg) grayscale frames. Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np


def load_frames(frames_dir: str, max_frames: int) -> list[np.ndarray]:
    d = pathlib.Path(frames_dir)
    paths = sorted(
        p for p in d.iterdir() if p.suffix.lower() in (".pgm", ".png", ".jpg", ".jpeg")
    )[:max_frames]
    if len(paths) < 2:
        raise SystemExit(f"need >=2 frames in {frames_dir}")
    out = []
    for p in paths:
        if p.suffix.lower() == ".pgm":
            from ethzasl_brisk_tpu_torch.core.image_io import read_pgm

            out.append(read_pgm(str(p)))
        else:
            from PIL import Image

            out.append(np.asarray(Image.open(p).convert("L")))
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ethzasl_brisk_tpu_torch.vo")
    ap.add_argument("frames_dir")
    ap.add_argument("--gt", default=None)
    ap.add_argument("--gt-format", choices=["tum", "kitti"], default="kitti")
    ap.add_argument("--fu", type=float, default=718.856)   # KITTI 00 cam0
    ap.add_argument("--fv", type=float, default=718.856)
    ap.add_argument("--cu", type=float, default=607.1928)
    ap.add_argument("--cv", type=float, default=185.2157)
    ap.add_argument("--max-frames", type=int, default=500)
    ap.add_argument("--window", type=int, default=6)
    ap.add_argument("--kf-parallax", type=float, default=12.0)
    ap.add_argument("--kf-min-inliers", type=int, default=60)
    ap.add_argument("--max-keypoints", type=int, default=1024)
    ap.add_argument("--threshold", type=float, default=30.0)
    ap.add_argument("--no-ba", action="store_true")
    ap.add_argument("--ba-min-track-len", type=int, default=3)
    ap.add_argument("--ba-max-obs-residual", type=float, default=8.0,
                    help="pre-BA track gate: drop observations whose initial reprojection "
                         "residual exceeds this (px) and landmarks left with < min-track-len "
                         "observations (0 disables)")
    ap.add_argument("--ba-solver", choices=["lm", "trimmed", "gn"], default="trimmed",
                    help="lm = Levenberg-Marquardt with step accept/reject; trimmed = two-stage "
                         "LM with gross-outlier rejection between stages; gn = fixed-damping "
                         "Gauss-Newton")
    ap.add_argument("--ba-iters", type=int, default=12)
    ap.add_argument("--ba-max-shift", type=float, default=0.0,
                    help="if > 0, reject a window solution that moves any keyframe center by "
                         "more than this multiple of the window's median baseline")
    ap.add_argument("--ba-huber", type=float, default=3.0, help="Huber delta in px (0 disables)")
    ap.add_argument("--ba-max-trim-frac", type=float, default=0.08,
                    help="trimmed solver: skip a window whose stage-1 outlier-trim fraction "
                         "exceeds this")
    ap.add_argument("--no-ba-scale-projection", action="store_true",
                    help="disable the per-window monocular scale-gauge projection")
    ap.add_argument("--no-refine", action="store_true",
                    help="disable GN relative-pose refinement")
    ap.add_argument("--min-inlier-spread", type=float, default=0.15,
                    help="reject relative poses whose RANSAC inlier bounding box covers less "
                         "than this fraction of the frame area (0 disables)")
    ap.add_argument("--no-normalize-exposure", action="store_true",
                    help="disable per-frame photometric normalization")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="checkpoint directory; resumes from the latest step if one exists "
                         "(failure recovery)")
    ap.add_argument("--checkpoint-every", type=int, default=10,
                    help="checkpoint every N keyframes")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--json", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from ethzasl_brisk_tpu_torch.geometry.cameras import PinholeCamera
    from ethzasl_brisk_tpu_torch.vo.evaluate import load_kitti_trajectory, load_tum_trajectory
    from ethzasl_brisk_tpu_torch.vo.sequence import KEYFRAMED_DEFAULTS, run_keyframed

    if args.ba_max_obs_residual or args.min_inlier_spread:
        print(f"NOTE: pre-BA residual gate ({args.ba_max_obs_residual} px) and inlier-spread "
              f"gate ({args.min_inlier_spread}) are ON; pass --ba-max-obs-residual 0 "
              "--min-inlier-spread 0 for the ungated behavior.", file=sys.stderr)
    frames = load_frames(args.frames_dir, args.max_frames)
    h, w = frames[0].shape
    cam = PinholeCamera(args.fu, args.fv, args.cu, args.cv, w, h)
    gt_poses = None
    if args.gt:
        if args.gt_format == "kitti":
            gt_poses = load_kitti_trajectory(args.gt)
        else:
            # TUM rows are (timestamp, position, xyzw quaternion).
            from ethzasl_brisk_tpu_torch.vo.evaluate import quat_to_rot

            _, pos, quat = load_tum_trajectory(args.gt)
            gt_poses = np.tile(np.eye(4), (len(pos), 1, 1))
            gt_poses[:, :3, :3] = quat_to_rot(quat)
            gt_poses[:, :3, 3] = pos
    flags = {k: getattr(args, k) for k in KEYFRAMED_DEFAULTS}
    result = run_keyframed(frames, cam, gt_poses, device=args.device, **flags)
    result.pop("poses")
    if args.json:
        print(json.dumps(result))
    else:
        for k, v in result.items():
            tag = {"ate_rmse": "ATE RMSE"}.get(k, k)
            print(f"{tag}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
