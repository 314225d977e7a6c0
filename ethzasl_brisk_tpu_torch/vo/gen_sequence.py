"""Generate a synthetic monocular sequence with KITTI ground truth (the
port of ``tools/gen_synthetic_seq.py``).

    python -m ethzasl_brisk_tpu_torch.vo.gen_sequence OUT_DIR [--frames 30] [--seed 3]

Renders the textured two-depth scene (``frames.render_scene``) along a
smooth forward-and-turn path and writes ``frame_%04d.pgm`` and
``poses.txt`` (KITTI odometry: 12 numbers a line, world-from-camera
[R|t]), the JAX tool's files byte for byte. Host numpy only: it runs no
device code.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

CAMERA = (400.0, 400.0, 320.0, 240.0, 640, 480)


def write_sequence(out_dir, frames: int = 30, seed: int = 3) -> None:
    """The sequence's frames and ``poses.txt`` in ``out_dir``."""
    from scipy import ndimage

    from ethzasl_brisk_tpu_torch.core.image_io import write_pgm
    from ethzasl_brisk_tpu_torch.frames import render_scene
    from ethzasl_brisk_tpu_torch.geometry import PinholeCamera

    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    tex = ndimage.gaussian_filter(rng.uniform(0, 255, (480, 640)), 2.0)
    tex = ((tex - tex.min()) / (np.ptp(tex) + 1e-9) * 255).astype(np.uint8)
    cam = PinholeCamera(*CAMERA)
    lines = []
    for i in range(frames):
        # Smooth yaw + translation (camera-from-world R, t).
        a = 0.008 * i
        r = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        t = np.array([0.08 * i, 0.01 * np.sin(0.3 * i), 0.02 * i])
        write_pgm(str(out / f"frame_{i:04d}.pgm"), render_scene(tex, cam, r, t))
        # KITTI ground truth: world-from-camera [R|t].
        m = np.hstack([r.T, (-r.T @ t)[:, None]])
        lines.append(" ".join(f"{v:.9e}" for v in m.reshape(-1)))
    (out / "poses.txt").write_text("\n".join(lines) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ethzasl_brisk_tpu_torch.vo.gen_sequence")
    ap.add_argument("out_dir")
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args(argv)
    write_sequence(args.out_dir, args.frames, args.seed)
    print(f"wrote {args.frames} frames + poses.txt to {pathlib.Path(args.out_dir)}")
    print("camera: fu=fv=400 cu=320 cv=240 (pass --fu 400 --fv 400 "
          "--cu 320 --cv 240 to kitti_eval)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
