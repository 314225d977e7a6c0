"""Run the VO front-end over an image sequence and evaluate ATE (the port
of ``tools/sequence_eval.py``, the config-3 harness).

    python -m ethzasl_brisk_tpu_torch.vo.sequence_eval FRAMES_DIR [--gt FILE]
        [--gt-format tum|kitti] [--fu F --fv F --cu C --cv C]
        [--max-frames 200] [--device cuda|cpu]

Frames: the directory's sorted ``.pgm`` files. ``run_sequence_eval``
(``VoFrontend.run_sequence`` with the tool's detector and ``VoConfig``'s
defaults) integrates the poses; it prints the pose count and path length
and, with ``--gt`` (TUM rows ``timestamp tx ty tz qx qy qz qw``, or KITTI),
the similarity-aligned ATE RMSE, in the JAX tool's lines. Runs on the card
unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import pathlib
import sys


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ethzasl_brisk_tpu_torch.vo.sequence_eval")
    ap.add_argument("frames_dir")
    ap.add_argument("--gt", default=None)
    ap.add_argument("--gt-format", choices=["tum", "kitti"], default="tum")
    ap.add_argument("--fu", type=float, default=525.0)
    ap.add_argument("--fv", type=float, default=525.0)
    ap.add_argument("--cu", type=float, default=319.5)
    ap.add_argument("--cv", type=float, default=239.5)
    ap.add_argument("--max-frames", type=int, default=200)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from ethzasl_brisk_tpu_torch.core.image_io import read_pgm_batch
    from ethzasl_brisk_tpu_torch.geometry import PinholeCamera
    from ethzasl_brisk_tpu_torch.vo.evaluate import load_kitti_trajectory, load_tum_trajectory
    from ethzasl_brisk_tpu_torch.vo.sequence import run_sequence_eval

    paths = sorted(str(p) for p in pathlib.Path(args.frames_dir).glob("*.pgm"))[: args.max_frames]
    if len(paths) < 2:
        raise SystemExit("need at least two .pgm frames")
    frames = read_pgm_batch(paths)
    h, w = frames.shape[1:]
    gt_pos = None
    if args.gt:
        if args.gt_format == "tum":
            _, gt_pos, _ = load_tum_trajectory(args.gt)
        else:
            gt_pos = load_kitti_trajectory(args.gt)[:, :3, 3]
    cam = PinholeCamera(args.fu, args.fv, args.cu, args.cv, w, h)
    out = run_sequence_eval(list(frames), cam, gt_pos, device=args.device)
    print(f"integrated {len(out['poses'])} poses; path length {out['path_length']:.2f}")
    if gt_pos is not None:
        print(f"ATE RMSE (sim-aligned): {out['ate_rmse']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
