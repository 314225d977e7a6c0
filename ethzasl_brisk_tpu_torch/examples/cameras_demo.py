"""Camera-model + camera-aware feature demo (port of
``examples/cameras_demo.py``).

    python -m ethzasl_brisk_tpu_torch.examples.cameras_demo [--device cuda|cpu]

The counterpart of the reference's ``test-cameras`` binary
(``brisk/src/test-cameras.cc:40-174``): build distorted cameras, project
and unproject point clouds, and run camera-aware (virtual-undistorted)
feature extraction on a synthetic capture. Runs on the card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ethzasl_brisk_tpu_torch.examples.cameras_demo")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from scipy import ndimage

    from ethzasl_brisk_tpu_torch.core.device import resolve_device
    from ethzasl_brisk_tpu_torch.geometry import (
        EquidistantDistortion,
        PinholeCamera,
        RadialTangentialDistortion,
    )
    from ethzasl_brisk_tpu_torch.geometry.camera_aware import CameraAwareFeature
    from ethzasl_brisk_tpu_torch.pipeline import BriskFeature

    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    for name, dist in [
        ("pinhole (no distortion)", None),
        ("radial-tangential", RadialTangentialDistortion(-0.3, 0.1, 1e-3, -2e-3)),
        ("equidistant", EquidistantDistortion(-0.01, 0.007, -0.002, 0.001)),
    ]:
        cam = PinholeCamera(450.0, 451.0, 320.0, 240.0, 640, 480, dist)
        pts = rng.uniform([-1, -1, 2], [1, 1, 8], (5000, 3)).astype(np.float32)
        kp, valid = cam.project(torch.from_numpy(pts).to(dev))
        rays = cam.unproject(kp)
        p = pts / np.linalg.norm(pts, axis=1, keepdims=True)
        valid = valid.cpu().numpy()
        cos = np.abs((rays.cpu().numpy() * p).sum(1))[valid]
        print(f"{name:<26} projected {int(valid.sum())}/5000 in-image; "
              f"unproject alignment: min cos {cos.min():.6f}")

    # Camera-aware extraction on a distorted synthetic capture.
    tex = ndimage.gaussian_filter(rng.uniform(0, 255, (480, 640)), 1.5)
    tex = ((tex - tex.min()) / (np.ptp(tex) + 1e-9) * 255).astype(np.uint8)
    dist = RadialTangentialDistortion(-0.25, 0.06, 0.0, 0.0)
    cam = PinholeCamera(450.0, 450.0, 320.0, 240.0, 640, 480, dist)
    feature = BriskFeature(octaves=1, uniformity_radius=0.0, absolute_threshold=40.0,
                           max_candidates=512, max_keypoints=512, device=dev)
    caf = CameraAwareFeature(camera=cam, feature=feature)
    kps, desc, warped = caf.detect_and_compute(torch.from_numpy(tex))
    print(f"camera-aware extraction: {int(kps.count())} keypoints "
          f"(mapped back into the distorted frame)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
