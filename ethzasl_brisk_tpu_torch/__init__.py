"""PyTorch + CUDA port of ``ethzasl_brisk_tpu`` for NVIDIA Hopper.

Mirrors the JAX package module by module (``core/``, ``kernels/``,
``detect/``, ``describe/``, ``match/``, ``parallel/``, ``pipeline.py``).
The JAX package stays the reference; this package imports neither it nor
JAX. Its two TPU kernels on the main path are hand-written CUDA here
(``csrc/``), built with ``nvcc`` the first time a CUDA tensor reaches them.
"""
from ethzasl_brisk_tpu_torch.core.keypoints import KeyPoints
from ethzasl_brisk_tpu_torch.parallel.frames import FramePipeline
from ethzasl_brisk_tpu_torch.pipeline import BriskFeature

__all__ = ["BriskFeature", "FramePipeline", "KeyPoints"]
