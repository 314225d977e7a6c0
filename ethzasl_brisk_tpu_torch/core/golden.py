"""Reader and writer of the reference's golden verification sets (.set).

The port's own copy of the JAX package's ``core/golden.py`` (numpy only).
Binary layout (little-endian), per ``brisk/src/test/serialization.{h,cc}``
and ``bench-ds.cc:73-80``:

  file     := vector<DatasetEntry>          (u32 count + entries)
  entry    := path (u32 len + bytes)
              imgGray   : Mat
              keypoints : vector<KeyPoint>
              descriptors : Mat
              userdata  : map<string, Blob> (u32 count + pairs)
  Mat      := rows i32, cols i32, type i32, elemSize i32, data
  KeyPoint := angle f32, class_id i32, octave i32, x f32, y f32,
              response f32, size f32
  Blob     := u32 size + bytes

``descriptor_bytes`` turns the port's (K, 12) int32 descriptor words into
the (N, 48) uint8 rows a set stores, and ``golden_entry`` builds an entry
from the port's outputs, so that its results can be checked keypoint by
keypoint and byte by byte against a set, or written as one.
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np

_CV_DEPTH_DTYPES = {
    0: np.uint8,    # CV_8U
    1: np.int8,     # CV_8S
    2: np.uint16,   # CV_16U
    3: np.int16,    # CV_16S
    4: np.int32,    # CV_32S
    5: np.float32,  # CV_32F
    6: np.float64,  # CV_64F
}


@dataclasses.dataclass
class GoldenKeyPoint:
    angle: float
    class_id: int
    octave: int
    x: float
    y: float
    response: float
    size: float


@dataclasses.dataclass
class GoldenEntry:
    path: str
    image: np.ndarray
    keypoints: list[GoldenKeyPoint]
    descriptors: np.ndarray  # (N, bytes) uint8
    userdata: dict[str, bytes]

    def keypoint_array(self) -> np.ndarray:
        """Structured (N, 7) float64 array: x, y, size, angle, response,
        octave, class_id."""
        return np.array(
            [
                [k.x, k.y, k.size, k.angle, k.response, k.octave, k.class_id]
                for k in self.keypoints
            ],
            dtype=np.float64,
        ).reshape(-1, 7)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        if len(out) != n:
            raise EOFError("truncated .set file")
        self.pos += n
        return out

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.take(4))[0]

    def f32(self) -> float:
        return struct.unpack("<f", self.take(4))[0]

    def string(self) -> str:
        return self.take(self.u32()).decode("latin-1")

    def mat(self) -> np.ndarray:
        rows, cols, cvtype, elem_size = (
            self.i32(),
            self.i32(),
            self.i32(),
            self.i32(),
        )
        raw = self.take(elem_size * rows * cols)
        depth = cvtype & 7
        channels = (cvtype >> 3) + 1
        dtype = _CV_DEPTH_DTYPES[depth]
        arr = np.frombuffer(raw, dtype=dtype)
        if channels == 1:
            return arr.reshape(rows, cols).copy() if rows else arr.copy()
        return arr.reshape(rows, cols, channels).copy()

    def keypoint(self) -> GoldenKeyPoint:
        angle = self.f32()
        class_id = self.i32()
        octave = self.i32()
        x = self.f32()
        y = self.f32()
        response = self.f32()
        size = self.f32()
        return GoldenKeyPoint(angle, class_id, octave, x, y, response, size)


def read_set(path: str) -> list[GoldenEntry]:
    with open(path, "rb") as f:
        r = _Reader(f.read())
    entries = []
    for _ in range(r.u32()):
        epath = r.string()
        img = r.mat()
        kps = [r.keypoint() for _ in range(r.u32())]
        desc = r.mat()
        userdata = {}
        for _ in range(r.u32()):
            name = r.string()
            blob = r.take(r.u32())
            userdata[name] = blob
        entries.append(
            GoldenEntry(
                path=epath,
                image=img,
                keypoints=kps,
                descriptors=np.atleast_2d(desc).astype(np.uint8),
                userdata=userdata,
            )
        )
    return entries


class _Writer:
    def __init__(self):
        self.parts: list[bytes] = []

    def u32(self, v: int):
        self.parts.append(struct.pack("<I", v))

    def i32(self, v: int):
        self.parts.append(struct.pack("<i", v))

    def f32(self, v: float):
        self.parts.append(struct.pack("<f", v))

    def string(self, s: str):
        b = s.encode("latin-1")
        self.u32(len(b))
        self.parts.append(b)

    def mat(self, arr: np.ndarray):
        """Serialize a 2-D array in the reference cv-Mat layout."""
        arr = np.atleast_2d(arr)
        depth = {v: k for k, v in _CV_DEPTH_DTYPES.items()}[
            np.dtype(arr.dtype).type
        ]
        self.i32(arr.shape[0])
        self.i32(arr.shape[1])
        self.i32(depth)  # single channel
        self.i32(arr.dtype.itemsize)
        self.parts.append(np.ascontiguousarray(arr).tobytes())


def write_set(path: str, entries: list[GoldenEntry]) -> None:
    """Write the reference's ``.set`` layout (serialization.h:50-131) —
    lets this framework's outputs be byte-compared by the reference's own
    verification harness."""
    w = _Writer()
    w.u32(len(entries))
    for e in entries:
        w.string(e.path)
        w.mat(e.image)
        w.u32(len(e.keypoints))
        for k in e.keypoints:
            w.f32(k.angle)
            w.i32(k.class_id)
            w.i32(k.octave)
            w.f32(k.x)
            w.f32(k.y)
            w.f32(k.response)
            w.f32(k.size)
        w.mat(e.descriptors)
        w.u32(len(e.userdata))
        for name, blob in e.userdata.items():
            w.string(name)
            w.u32(len(blob))
            w.parts.append(blob)
    with open(path, "wb") as f:
        f.write(b"".join(w.parts))


def descriptor_bytes(words, valid=None) -> np.ndarray:
    """(K, W) int32 descriptor words (torch or numpy) -> (N, 4W) uint8 rows
    of the slots where ``valid`` holds (all without it), each word's bytes
    little-endian first: the layout the JAX package's ``tools/parity.py``
    compares (its uint32 words viewed as bytes)."""
    w = np.asarray(words.cpu() if hasattr(words, "cpu") else words).astype("<i4")
    if valid is not None:
        w = w[np.asarray(valid.cpu() if hasattr(valid, "cpu") else valid, bool)]
    return np.ascontiguousarray(w).view(np.uint8).reshape(w.shape[0], -1)


def golden_entry(path: str, image, keypoints, words, userdata=None,
                 class_id: int = -1) -> GoldenEntry:
    """A set entry from the port's outputs: ``keypoints`` (KeyPoints of one
    image) and their (K, W) int32 descriptor words, valid slots only, in
    slot order; ``class_id`` is cv::KeyPoint's default."""
    host = keypoints.to_numpy()
    kps = [
        GoldenKeyPoint(float(a), class_id, int(o), float(x), float(y), float(r), float(s))
        for a, o, x, y, r, s in zip(host["angle"], host["octave"], host["x"], host["y"],
                                    host["response"], host["size"])
    ]
    return GoldenEntry(
        path=path,
        image=np.asarray(image.cpu() if hasattr(image, "cpu") else image),
        keypoints=kps,
        descriptors=descriptor_bytes(words, keypoints.valid),
        userdata=dict(userdata or {}),
    )
