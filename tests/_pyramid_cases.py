"""uint8 frames for the pyramid, shared by the CPU tests
(``test_torch_pyramid.py``) and the card's (``test_torch_gpu.py``). numpy
only: the card's tests import no JAX.

The shapes: VGA, odd sizes whose layers floor on every side, and frames so
small that some layers are empty."""
import numpy as np

SHAPES = ((2, 480, 640), (3, 61, 83), (3, 96, 130), (3, 3, 3), (3, 2, 5), (3, 1, 7))
IDS = tuple(f"{h}x{w}" for _, h, w in SHAPES)
LAYERS = (2, 4, 6)


def frames(b, h, w):
    """Noise, a frame at 255 (the rounding's top) and, from the third on, a
    frame of 0 with bright noise columns: seeded by the shape."""
    rng = np.random.default_rng(h * 1000 + w)
    f = rng.integers(0, 256, (b, h, w), dtype=np.uint8)
    if b > 1:
        f[1] = 255
    if b > 2:
        f[2] = 0
        f[2, :, ::3] = rng.integers(200, 256, f[2, :, ::3].shape, dtype=np.uint8)
    return f
