"""Grayscale PGM image IO (port of ``core/image_io.py``).

The reference test corpus is 8-bit binary PGM; the reference's own loader
is ``brisk/src/brisk-opencv.cc:67+``. This is the JAX package's NumPy
netpbm reader (P2 ascii or P5 binary, 8- or 16-bit) and P5 writer; the
batch reader runs it on a thread pool (the JAX package's native threaded
loader is not part of the port). Images stay numpy arrays: callers move
them with ``torch.from_numpy(...).to(device)``.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np


def read_pgm(path: str) -> np.ndarray:
    """Read an 8-bit (uint8) or 16-bit (uint16) PGM as an (H, W) array."""
    with open(path, "rb") as f:
        data = f.read()

    # Header tokens: magic, width, height, maxval; '#' starts a comment.
    pos = 0

    def next_token():
        nonlocal pos
        while pos < len(data):
            c = data[pos : pos + 1]
            if c == b"#":
                while pos < len(data) and data[pos : pos + 1] != b"\n":
                    pos += 1
            elif c.isspace():
                pos += 1
            else:
                break
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        return data[start:pos]

    magic = next_token()
    if magic not in (b"P2", b"P5"):
        raise ValueError(f"not a PGM file: magic={magic!r}")
    width = int(next_token())
    height = int(next_token())
    maxval = int(next_token())
    dtype = np.dtype(np.uint8) if maxval < 256 else np.dtype(">u2")

    if magic == b"P5":
        pos += 1  # single whitespace after maxval
        raster = np.frombuffer(data, dtype=dtype, count=width * height, offset=pos)
    else:
        vals = data[pos:].split()
        raster = np.array([int(v) for v in vals[: width * height]], dtype=dtype)
    img = raster.reshape(height, width)
    # A writable copy (np.frombuffer is read-only), so torch.from_numpy takes it.
    return np.array(img, dtype=np.uint16 if maxval >= 256 else np.uint8)


def read_pgm_batch(paths, n_threads: int = 8) -> np.ndarray:
    """Read same-sized PGMs into one (N, H, W) array, ``n_threads`` at a time."""
    with ThreadPoolExecutor(max_workers=n_threads) as pool:
        return np.stack(list(pool.map(read_pgm, paths)))


def write_pgm(path: str, img: np.ndarray) -> None:
    """Write a 2-D uint8/uint16 array as binary PGM (P5)."""
    img = np.asarray(img)
    if img.ndim != 2:
        raise ValueError("write_pgm expects a 2-D array")
    if img.dtype == np.uint8:
        maxval = 255
        payload = img.tobytes()
    elif img.dtype == np.uint16:
        maxval = 65535
        payload = img.astype(">u2").tobytes()
    else:
        raise ValueError(f"unsupported dtype {img.dtype}")
    header = f"P5\n{img.shape[1]} {img.shape[0]}\n{maxval}\n".encode()
    with open(path, "wb") as f:
        f.write(header + payload)
