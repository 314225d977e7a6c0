"""PyTorch + CUDA port of ``ethzasl_brisk_tpu`` for NVIDIA Hopper.

Mirrors the JAX package module by module (``core/``, ``kernels/``,
``detect/``, ``describe/``, ``match/``, ``geometry/``, ``vo/``, ``ba/``,
``parallel/``, ``utils/``, ``examples/``, ``pipeline.py``).
The JAX package stays the reference; this package imports neither it nor
JAX. Its TPU kernels are hand-written CUDA here (``csrc/``), built with
``nvcc`` the first time a CUDA tensor reaches them.

The entry points (``BriskFeature``, ``BriskExtractor``,
``HarrisFeatureDetector``, ``FramePipeline``, the classic AGAST/OAST
``BriskFeatureDetector`` with ``compute_scale``, and ``AstFramePipeline``)
run on the card unless given
``device="cpu"``; they move their input images there. ``version="v1"``
selects the v1 engine. ``geometry`` holds the cameras, the camera-aware
path (``geometry/camera_aware.py``) and RANSAC (``geometry/ransac.py``);
``vo`` the VO front-end, tracks, trajectory evaluation and the keyframed
VO + window-BA loop (``python -m ethzasl_brisk_tpu_torch.vo``); ``ba`` the
SE(3) helpers, windowed bundle adjustment and the pose graph; ``probes``
the TPU gather probes as GPU probes (``python -m
ethzasl_brisk_tpu_torch.probes``); ``utils`` the timing registry,
checkpoints and roofline accounting; ``parallel`` the steps over a
``torch.distributed`` device mesh, the sharded knn, BA and pose graph
(``python -m ethzasl_brisk_tpu_torch.parallel worker|dryrun``);
``examples`` the JAX package's examples.

Quick start (one image, on the card)::

    img = torch.from_numpy(read_pgm("img1.pgm"))
    feature = BriskFeature(octaves=0, uniformity_radius=30.0,
                           absolute_threshold=20.0, fused_mask=True)
    keypoints, descriptors = feature.detect_and_compute(img)
"""
from ethzasl_brisk_tpu_torch.core.keypoints import KeyPoints
from ethzasl_brisk_tpu_torch.parallel.frames import AstFramePipeline, FramePipeline
from ethzasl_brisk_tpu_torch.pipeline import (
    BriskFeature,
    BriskFeatureDetector,
    HarrisFeatureDetector,
    compute_scale,
)

__all__ = ["AstFramePipeline", "BriskFeature", "BriskFeatureDetector", "FramePipeline",
           "HarrisFeatureDetector", "KeyPoints", "compute_scale"]
