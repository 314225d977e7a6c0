"""Live matching pipeline over an image directory (port of
``examples/live_pipeline.py``).

    python -m ethzasl_brisk_tpu_torch.examples.live_pipeline FRAMES_DIR [BATCH] [DRAW_DIR] \\
        [--device cuda|cpu]

The counterpart of the reference's ROS live demo
(``brisk_ros_demo/src/livedemo.cc``): instead of a ROS subscriber and
visualizer threads, a threaded loader (``read_pgm_batch``) streams PGM
frames into the batched step (``FramePipeline``), which detects,
describes and matches, and prints per-batch statistics (the demo's
FPS/HUD, livedemo.cc:213). Runs on the card unless ``--device cpu``.

Reference-demo semantics (livedemo.cc:316-344, 623-636): the demo
accumulates the first N_REF frames as a persistent REFERENCE collection
(``cv::DescriptorMatcher::add``) and radius-matches every incoming frame
against it, reporting per-reference-image match counts, beside the
consecutive-frame matching of the step (the batch-boundary pair included).

With DRAW_DIR, each matched pair is rendered like the reference
visualizer (livedemo.cc:224-296): the two frames side by side, keypoint
circles scaled by size and match lines, written as PGM files.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np
import torch

N_REF = 2          # reference frames accumulated (livedemo keeps 1-2)
MATCH_RADIUS = 90  # Hamming radius for the HUD counts
SENTINEL = 385


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ethzasl_brisk_tpu_torch.examples.live_pipeline")
    ap.add_argument("frames_dir")
    ap.add_argument("batch", nargs="?", type=int, default=8)
    ap.add_argument("draw_dir", nargs="?", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from ethzasl_brisk_tpu_torch.core.device import resolve_device
    from ethzasl_brisk_tpu_torch.core.image_io import read_pgm, read_pgm_batch, write_pgm
    from ethzasl_brisk_tpu_torch.match.matcher import (
        DescriptorCollection,
        hamming_distance_matrix,
        radius_match_collection,
    )
    from ethzasl_brisk_tpu_torch.parallel import FramePipeline
    from ethzasl_brisk_tpu_torch.pipeline import BriskFeature
    from ethzasl_brisk_tpu_torch.utils.timing import Timing, block_until_ready, timer

    dev = resolve_device(args.device)
    directory = pathlib.Path(args.frames_dir)
    batch = args.batch
    draw_dir = pathlib.Path(args.draw_dir) if args.draw_dir else None
    if draw_dir:
        draw_dir.mkdir(parents=True, exist_ok=True)
    paths = sorted(str(p) for p in directory.glob("*.pgm"))
    if not paths:
        raise SystemExit(f"no .pgm files in {directory}")
    # Cycle the directory so the demo always has full batches.
    while len(paths) < batch + 1:
        paths = paths + paths

    feature = BriskFeature(octaves=2, uniformity_radius=0.0, absolute_threshold=30.0,
                           max_candidates=512, max_keypoints=512, device=dev)
    pipe = FramePipeline(feature, dev)

    # One-shot capacity certification on the first frame: silently
    # truncating caps would skew every HUD count.
    _, diag = feature.detect_with_diagnostics(torch.from_numpy(read_pgm(paths[0])))
    if not bool(diag.ok):
        print("WARNING: detector capacity overflow on the first frame "
              f"(candidates {diag.cand_counts.tolist()} vs caps {diag.cand_caps.tolist()}) — "
              "weakest candidates are being dropped; raise max_candidates.")

    reference = DescriptorCollection()

    def boundary_match(qd, td, qv, tv):
        """Match the first frame of a batch against the previous batch's
        tail frame (the pair the in-batch step cannot see)."""
        d = hamming_distance_matrix(qd, td)
        d = torch.where(tv[None, :], d, torch.full_like(d, SENTINEL))
        best = torch.argmin(d, dim=1).to(torch.int32)
        bd = torch.gather(d, 1, best[:, None].to(torch.int64))[:, 0]
        return best, torch.where(qv, bd, torch.full_like(bd, SENTINEL))

    n_batches = max(1, (len(paths) - 1) // batch)
    prev_tail = None  # (frame, desc, valid) of the previous batch's tail
    for bi in range(n_batches):
        chunk = paths[bi * batch: bi * batch + batch]
        with timer("0 load (threaded)"):
            frames_np = read_pgm_batch(chunk)
        frames = torch.from_numpy(frames_np)
        with timer("1 detect+describe+match (device)"):
            kps, desc, midx, mdist = pipe.step(frames)
            block_until_ready(mdist)
        n_kp = kps.valid.sum(dim=1).cpu().numpy()
        n_match = (mdist < MATCH_RADIUS).sum(dim=1).cpu().numpy()

        # Batch-boundary pair: first frame of this batch vs the last frame
        # of the previous one.
        boundary_n = None
        if prev_tail is not None:
            _, bdist = boundary_match(desc[0], prev_tail[1], kps.valid[0], prev_tail[2])
            boundary_n = int((bdist < MATCH_RADIUS).sum())

        # Persistent reference-frame matching (livedemo semantics).
        if len(reference) < N_REF:
            for fi in range(min(N_REF - len(reference), len(chunk))):
                reference.add(desc[fi], kps.valid[fi])
            print(f"batch {bi}: reference collection now {len(reference)} frame(s)")
        with timer("2 radius-match vs reference (device)"):
            ref_counts = np.zeros((len(chunk), len(reference)), np.int64)
            for fi in range(len(chunk)):
                img_idx, _, _, _ = radius_match_collection(
                    desc[fi], reference, MATCH_RADIUS, query_valid=kps.valid[fi])
                ii = img_idx.cpu().numpy()
                for ri in range(len(reference)):
                    # matched (query, train) pairs landing on reference ri
                    ref_counts[fi, ri] = int(((ii >= 0) & (ii == ri)).sum())
        hud = "  ".join(f"ref{ri}:{ref_counts[:, ri].mean():.0f}"
                        for ri in range(len(reference)))
        print(f"batch {bi}: frames {len(chunk)}  "
              f"keypoints/frame {n_kp.mean():.0f}  "
              f"matches/pair {n_match.mean():.0f}"
              + (f"  boundary-pair {boundary_n}" if boundary_n is not None else "")
              + f"  ref-matches/frame [{hud}]")
        if draw_dir is not None:
            from ethzasl_brisk_tpu_torch.examples.draw import draw_matches

            host_kps = kps.map(lambda a: a.cpu().numpy())
            for pi in range(len(chunk) - 1):
                img = draw_matches(frames_np[pi], frames_np[pi + 1], host_kps, pi,
                                   midx[pi].cpu().numpy(), mdist[pi].cpu().numpy(),
                                   max_dist=MATCH_RADIUS)
                write_pgm(str(draw_dir / f"match_{bi:03d}_{pi:02d}.pgm"), img)
        prev_tail = (frames_np[-1], desc[-1], kps.valid[-1])
    print()
    print(Timing.print_timing())
    if draw_dir is not None:
        print(f"match visualizations written to {draw_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
