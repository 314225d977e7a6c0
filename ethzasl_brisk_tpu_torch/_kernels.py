"""Build, load and count the hand-written CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, loaded with
``ctypes``. The build runs the first time a CUDA tensor reaches a kernel,
never at import; it lands in ``build/kernels/`` at the root of the
checkout, keyed on a hash of the sources and flags, so an unchanged tree
reuses its library and an edited one rebuilds.

Every kernel wrapper launches through ``launch``: it calls the C entry
point, resolved once, on the tensors' card (switching the current device
only when another card is current), passes that card's current stream,
raises on a launch error and counts the launch in ``LAUNCHES`` (one per
launch, nowhere else) so a run can show that its main path went through
the kernels. For kernels of a few microseconds the launch path is most of
a call's time, so it builds no ``torch.cuda.Stream`` and takes no lock.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

_PKG = pathlib.Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH,
    "-std=c++17", "-O3",
    # Float chains (the sampler's weights) round op by op, as the plain
    # torch versions and XLA's separate ops do.
    "--fmad=false",
    "-Xptxas", "-v",
    "-Xcompiler", "-fPIC",
)

LAUNCHES = {
    # K1 and K3 count one per launch, which covers every pyramid layer of a call.
    "harris_score_i32": 0, "harris_score_mask": 0, "smoothed_intensity": 0,
    # K2's v1-rounding variant (the same entry point with its flag set).
    "smoothed_intensity_v1": 0,
    # The uint8 describe in one launch: both samplings, the long-pair
    # gradient, the angle chain and the descriptor words (csrc/describe.cu),
    # and its v1-rounding variant.
    "describe_rotated": 0, "describe_rotated_v1": 0,
    # The port's own kernels (no TPU counterpart): JAX's float32 angle chain
    # and the camera grid's walk back (csrc/angle.cu), the BA's ordered
    # segment sums, a call site's items in one launch (csrc/segment_sum.cu).
    "brisk_orientation": 0, "atan2f_elementwise": 0, "sincosf_elementwise": 0,
    "walk_angles": 0, "segment_sum": 0,
    # Greedy uniformity and the integer candidate masks (2-D maxima and the
    # 3-D checks), each every layer of a detection in one launch
    # (csrc/uniformity.cu, csrc/masks.cu).
    "enforce_uniformity": 0, "score_masks": 0,
    # The score-ordered candidate lists and the refine (compaction, taps,
    # sub-pixel fit, packing), each every layer of a detection in one
    # launch (csrc/candidates.cu, csrc/refine.cu).
    "layer_candidates": 0, "refine_keypoints": 0,
    # The batched step's adjacent-frame match (XOR, popcount and the first
    # index of the minimum, every pair in one launch; csrc/match.cu) and
    # every derived uint8 pyramid layer of a call in one launch
    # (csrc/pyramid.cu).
    "hamming_argmin": 0, "pyramid_u8": 0,
    # The latency probes behind segment_sum's and enforce_uniformity's chain
    # bounds (measure.add_latency_cycles, measure.round_latency_cycles).
    "add_latency": 0, "round_latency": 0,
    # The gather probes' kernels: G1, G2, C, W (probes/gather.py); T, X, S
    # (probes/mosaic.py).
    "probe_take": 0, "probe_point_gather": 0, "probe_relayout": 0, "probe_window_copy": 0,
    "probe_transpose_chain": 0, "probe_gather_chain": 0, "probe_window_colsum": 0,
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_entries: dict = {}  # entry name -> the loaded library's brisk_<entry>


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources() -> list[pathlib.Path]:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libbrisk_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> list[tuple[int, str]]:
    """Run commands concurrently: (return code, stdout + stderr) of each."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    results = []
    for p in procs:
        text, _ = p.communicate()
        results.append((p.returncode, text))
    return results


def build() -> pathlib.Path:
    """Compile the kernels unless a library for these sources exists.

    One ``nvcc -c`` per source, all started together, then one link.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    tmp = BUILD_DIR / f"{tag}.tmp"
    nvcc = _nvcc()
    cus = [s for s in _sources() if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in cus]
    try:
        results = _run_all(
            [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)] for s, o in zip(cus, objs)]
        )
        if all(rc == 0 for rc, _ in results):
            results += _run_all(
                [[nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]]
            )
        log = "\n".join(text for _, text in results)
        out.with_suffix(".log").write_text(log)
        if any(rc != 0 for rc, _ in results):
            raise RuntimeError(f"nvcc failed:\n{log}")
        os.replace(tmp, out)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.brisk_harris_score_layers.argtypes = [
                ctypes.POINTER(vp), ctypes.POINTER(vp),  # inputs, outputs per layer
                ctypes.POINTER(ci), ci, vp,              # (B, H, W) per layer, layers, stream
            ]
            lib.brisk_harris_score_layers.restype = ci
            lib.brisk_harris_score_mask_layers.argtypes = [
                ctypes.POINTER(vp), ctypes.POINTER(vp), ctypes.POINTER(vp),  # inputs, scores, masks
                ctypes.POINTER(ci), ci, ci, vp,  # (B, H, W) per layer, layers, threshold, stream
            ]
            lib.brisk_harris_score_mask_layers.restype = ci
            lib.brisk_smoothed_intensity.argtypes = [
                vp, ci, ci,                # integral, cols, frame_rows
                vp, vp,                    # key_x, key_y
                vp, vp, vp, vp, vp,        # pat_x, pat_y, sigma, scaling, scaling2
                vp, vp, ci, ci, ci, vp,    # row_base, out, K, P, v1_rounding, stream
            ]
            lib.brisk_smoothed_intensity.restype = ci
            lib.brisk_describe_rotated.argtypes = [
                vp, ci, ci, ci,            # integral, cols, frame_rows, rotate
                vp, vp, vp,                # scale index, valid, given angle
                vp, vp, vp,                # key_x, key_y, row_base
                vp, vp, vp, vp, vp,        # lut_x, lut_y, lut_sigma, lut_scaling, lut_scaling2
                vp, ci, ci,                # packed pair tables, L, n_bits
                vp, vp,                    # angle, desc
                ci, ci, ci, ci, ci, vp,    # K, P, n_rot, W, v1_rounding, stream
            ]
            lib.brisk_describe_rotated.restype = ci
            lib.brisk_probe_take.argtypes = [
                vp, vp, vp, ci, ci, ci,    # src, idx, out, src_bytes, out_bytes, along_rows
                ci, ci, ci, ci, ci,        # R, W, S, Ws, n
                ci, ci, ci, ci,            # the plan: body, vector, rows, copies,
                ci, ci, ci, vp,            # smem, grid, threads; stream
            ]
            lib.brisk_probe_take.restype = ci
            lib.brisk_probe_point_gather.argtypes = [
                vp, vp, vp, vp, ci, ci,    # tab, r, c, out, cols, n
                ci, ci, vp,                # the plan: vector, grid; stream
            ]
            lib.brisk_probe_point_gather.restype = ci
            lib.brisk_probe_relayout.argtypes = [vp, vp, ci, ci, ci, ci, vp]
            lib.brisk_probe_relayout.restype = ci
            lib.brisk_probe_window_copy.argtypes = [
                vp, vp, vp, vp, ci, ci,    # img, ax, ay, out, width, K
                ci, vp,                    # the plan: vector; stream
            ]
            lib.brisk_probe_window_copy.restype = ci
            lib.brisk_probe_transpose_chain.argtypes = [vp, vp, ci, ci, vp]
            lib.brisk_probe_transpose_chain.restype = ci
            lib.brisk_probe_gather_chain.argtypes = [vp, vp, vp, ci, vp]
            lib.brisk_probe_gather_chain.restype = ci
            lib.brisk_probe_window_colsum.argtypes = [vp, vp, vp, vp, ci, ci, vp]
            lib.brisk_probe_window_colsum.restype = ci
            lib.brisk_orientation.argtypes = [
                vp, vp, vp, vp,            # d0, d1, given angle, need
                vp, vp, ci, ci, ci, vp,    # angle, theta, K, n_rot, op_by_op, stream
            ]
            lib.brisk_orientation.restype = ci
            lib.brisk_atan2f_elementwise.argtypes = [vp, vp, vp, ci, vp]  # y, x, out, n, stream
            lib.brisk_atan2f_elementwise.restype = ci
            lib.brisk_sincosf_elementwise.argtypes = [vp, vp, vp, ci, vp]  # x, sin, cos, n, stream
            lib.brisk_sincosf_elementwise.restype = ci
            lib.brisk_walk_angles.argtypes = [
                vp, ci, ci, vp,            # maps (V, H, W, 2), H, W, view index
                vp, ci, vp, ci, vp, ci,    # base x, base y, size (pointer, stride each)
                vp, ci, vp, ci,            # the angle, or the direction's x and y
                vp, ci, vp, ci,            # reference x, y
                vp, ci, ci, vp,            # out, n, from_angle, stream
            ]
            lib.brisk_walk_angles.restype = ci
            lib.brisk_segment_sums.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ci, ci, vp,  # items, item count, is_double, stream
            ]
            lib.brisk_segment_sums.restype = ci
            lib.brisk_add_latency.argtypes = [ci, ci, vp, vp, vp]  # is_double, adds, cycles, sink, stream
            lib.brisk_add_latency.restype = ci
            lib.brisk_enforce_uniformity.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ci, ctypes.c_float,  # layers, layer count, scaling
                vp, vp, vp,                                          # lut, rounds, stream
            ]
            lib.brisk_enforce_uniformity.restype = ci
            lib.brisk_score_masks.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ci, ci, ci, vp,  # layers, layer count, frames,
            ]                                                    # threshold, stream
            lib.brisk_score_masks.restype = ci
            lib.brisk_layer_candidates.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ci, ci, ci,  # layers, layer count, frames, columns
                ci, ci, vp, vp, vp,  # is_float, cluster, counts, passes (or 0), stream
            ]
            lib.brisk_layer_candidates.restype = ci
            lib.brisk_refine_keypoints.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ci,          # layers, layer count
                ctypes.POINTER(ctypes.c_int64), ci,          # outputs, frames
                ci, ci, ci, ci, vp,  # columns, counts' columns, is_float, is_double, stream
            ]
            lib.brisk_refine_keypoints.restype = ci
            lib.brisk_hamming_argmin.argtypes = [
                vp, vp, vp, vp,            # desc, valid, best, dist
                ci, ci, ci, ci, vp,        # B, K, W, n_bits, stream
            ]
            lib.brisk_hamming_argmin.restype = ci
            lib.brisk_pyramid_u8.argtypes = [
                vp, ctypes.POINTER(ctypes.c_int64), ci,  # frames, layer table, layer count
                ci, ci, ci, vp,                          # B, H, W, stream
            ]
            lib.brisk_pyramid_u8.restype = ci
            lib.brisk_round_latency.argtypes = [ci, vp, vp, vp]  # rounds, cycles, sink, stream
            lib.brisk_round_latency.restype = ci
            lib.brisk_error_string.argtypes = [ci]
            lib.brisk_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _entry(entry: str):
    """The C entry point ``brisk_<entry>`` of the loaded library (loaded,
    and built, on first use), looked up once."""
    fn = _entries.get(entry)
    if fn is None:
        fn = _entries[entry] = getattr(library(), f"brisk_{entry}")
    return fn


def _current_device() -> int:
    # torch.cuda.current_device() without its lazy-init check: a launch's
    # tensors are on a card, so CUDA is initialised.
    return torch._C._cuda_getDevice()


def _raw_stream(index: int) -> int:
    # torch._C._cuda_getCurrentRawStream: card ``index``'s current stream as
    # a cudaStream_t integer, without the torch.cuda.Stream object that
    # torch.cuda.current_stream(index).cuda_stream builds a call.
    return torch._C._cuda_getCurrentRawStream(index)


def launch(entry: str, counter: str, device: torch.device, *args) -> None:
    """Launch the C entry point ``brisk_<entry>`` on card ``device``.

    The card is the current device for the call (a ctypes launch goes to
    the runtime's current device; the device is switched only when another
    card is current), the last argument is that card's current stream, a
    launch error raises, and ``LAUNCHES[counter]`` counts the launch.
    """
    if device.type != "cuda":
        raise ValueError(f"{entry}: launches need a CUDA device, got {device}")
    fn = _entry(entry)
    current = _current_device()
    index = current if device.index is None else device.index
    if index == current:
        err = fn(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, _raw_stream(index))
    if err != 0:
        msg = library().brisk_error_string(err).decode()
        raise RuntimeError(f"{entry}: CUDA launch failed: error {err} ({msg})")
    LAUNCHES[counter] += 1
