"""Long synthetic-sequence VO accuracy benchmark (the port of
``tools/synthetic_vo_bench.py``, the stand-in for BASELINE configs 3-4).

    python -m ethzasl_brisk_tpu_torch.vo.synthetic [--frames 200] [--stress]
        [--normalize-exposure] [--seed 11] [--export DIR] [--json-out FILE]
        [--device cuda|cpu]

Renders a two-depth scene (``frames.make_texture``, ``trajectory``,
``render_scene``) along a known path at VGA (f = 400) and runs the VO
front-end (detect, describe, ratio/cross-check match, RANSAC essential,
GN refinement; ``VoFrontend.run_sequence``) against the ground truth.
``--stress`` adds a sinusoidal gain and bias (+-25 %, +-12 grey levels) and
a moving textured occluder over ~8 % of the frame. ``--export DIR`` writes
the frames as PGM with KITTI ``poses.txt`` (for ``python -m
ethzasl_brisk_tpu_torch.vo``) and exits. Prints the tool's lines and its
JSON line, ``{"metric": "synthetic_vo_ate_rmse_simaligned[_stress]", ...}``.
Runs on the card unless ``--device cpu``. The 200-frame ATE is chaotic
under small detector changes, so a robustness claim needs several seeds.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

CAMERA = (400.0, 400.0, 320.0, 240.0, 640, 480)
FEATURE = dict(octaves=2, uniformity_radius=0.0, absolute_threshold=30.0, max_candidates=1024,
               max_keypoints=1024)


def render_frames(n: int, seed: int = 11, stress: bool = False):
    """(frames, poses): n (480, 640) uint8 frames of the scene and their
    camera-from-world poses (R, t), as the JAX tool renders them."""
    from ethzasl_brisk_tpu_torch.frames import make_texture, render_scene, trajectory
    from ethzasl_brisk_tpu_torch.geometry import PinholeCamera

    rng = np.random.default_rng(seed)
    tex = make_texture(rng)
    cam = PinholeCamera(*CAMERA)
    poses = trajectory(n)
    occ_tex = make_texture(rng, 160, 200)
    frames = []
    for i, (r, t) in enumerate(poses):
        f = render_scene(tex, cam, r, t).astype(np.float32)
        if stress:
            gain = 1.0 + 0.25 * np.sin(0.11 * i)
            bias = 12.0 * np.sin(0.07 * i + 1.0)
            f = f * gain + bias
            # A moving textured occluder (~8 % of the frame).
            oy = int(160 + 120 * np.sin(0.05 * i))
            ox = int(40 + 380 * (0.5 + 0.5 * np.sin(0.023 * i)))
            f[oy:oy + 160, ox:ox + 200] = occ_tex[: min(160, 480 - oy), : min(200, 640 - ox)]
        frames.append(np.clip(f, 0, 255).astype(np.uint8))
    return frames, poses


def export(frames, poses, out_dir) -> None:
    """The frames as ``%06d.pgm`` and KITTI ``poses.txt`` (world-from-camera
    [R|t], 12 numbers a line) in ``out_dir``."""
    from ethzasl_brisk_tpu_torch.core.image_io import write_pgm

    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    gt_lines = []
    for i, (f, (r, t)) in enumerate(zip(frames, poses)):
        write_pgm(str(out / f"{i:06d}.pgm"), f)
        m = np.hstack([r.T, (-r.T @ t)[:, None]])
        gt_lines.append(" ".join(f"{v:.9f}" for v in m.reshape(-1)))
    (out / "poses.txt").write_text("\n".join(gt_lines) + "\n")


def evaluate(est, poses) -> dict:
    """ATE RMSE (similarity-aligned), RPE-t and path length of the
    estimated world-from-camera poses against the ground truth."""
    from ethzasl_brisk_tpu_torch.vo.evaluate import ate_rmse, rpe

    gt_pose = []
    for r, t in poses:
        m = np.eye(4)
        m[:3, :3] = r.T
        m[:3, 3] = -r.T @ t  # world-from-camera position
        gt_pose.append(m)
    est_pos = np.stack([p[:3, 3] for p in est])
    gt_pos = np.stack([m[:3, 3] for m in gt_pose])
    n = min(len(gt_pos), len(est_pos))
    ate = ate_rmse(est_pos[:n], gt_pos[:n], with_scale=True)
    path_len = float(np.linalg.norm(np.diff(gt_pos[:n], axis=0), axis=1).sum())
    try:
        rpe_t = float(rpe(np.stack(est[:n]), np.stack(gt_pose[:n]))[0])
    except Exception:  # the JAX tool's guard: RPE of a degenerate run is NaN
        rpe_t = float("nan")
    return dict(frames=n, ate=float(ate), path_length=path_len, rpe_t=rpe_t)


def run(frames, normalize_exposure: bool = False, device="cuda", generator=None, draw=None):
    """The tool's front-end over the frames: world-from-camera 4x4 poses."""
    from ethzasl_brisk_tpu_torch.geometry import PinholeCamera
    from ethzasl_brisk_tpu_torch.pipeline import BriskFeature
    from ethzasl_brisk_tpu_torch.vo.frontend import VoConfig, VoFrontend

    vo = VoFrontend(PinholeCamera(*CAMERA), BriskFeature(**FEATURE, device=device),
                    VoConfig(normalize_exposure=normalize_exposure))
    return vo.run_sequence(frames, generator=generator, draw=draw)


def result_line(stats: dict, stress: bool) -> str:
    """The tool's JSON line (its metric name, keys and rounding)."""
    ate, path_len = stats["ate"], stats["path_length"]
    return json.dumps({
        "metric": "synthetic_vo_ate_rmse_simaligned" + ("_stress" if stress else ""),
        "value": round(ate, 4),
        "unit": "m",
        "frames": stats["frames"],
        "path_length": round(path_len, 2),
        "ate_pct_of_path": round(100 * ate / path_len, 3),
    })


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ethzasl_brisk_tpu_torch.vo.synthetic")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--stress", action="store_true", help="exposure drift + moving occluder")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--normalize-exposure", action="store_true",
                    help="per-frame photometric normalization before detection "
                         "(VoConfig.normalize_exposure)")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--seed", type=int, default=11,
                    help="texture/occluder RNG seed (trajectory fixed); the 200-frame ATE is "
                         "chaotic under small detector changes, so robustness claims need "
                         "several seeds")
    ap.add_argument("--export", default=None,
                    help="write frames as PGM + KITTI poses.txt to DIR (for python -m "
                         "ethzasl_brisk_tpu_torch.vo keyframed+BA runs) and exit")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    frames, poses = render_frames(args.frames, args.seed, args.stress)
    print(f"rendered {len(frames)} frames ({'stress' if args.stress else 'clean'})", flush=True)
    if args.export:
        export(frames, poses, args.export)
        print(f"exported to {pathlib.Path(args.export)}")
        return 0
    stats = evaluate(run(frames, args.normalize_exposure, args.device), poses)
    ate, path_len = stats["ate"], stats["path_length"]
    print(f"frames {stats['frames']}  path length {path_len:.2f}  ATE RMSE (sim-aligned) "
          f"{ate:.4f} ({100 * ate / path_len:.2f}% of path)  RPE-t {stats['rpe_t']:.4f}",
          flush=True)
    line = result_line(stats, args.stress)
    print(line)
    if args.json_out:
        pathlib.Path(args.json_out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
