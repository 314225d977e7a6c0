"""Build, load and count the hand-written CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, loaded with
``ctypes``. The build runs the first time a CUDA tensor reaches a kernel,
never at import; it lands in ``build/kernels/`` at the root of the
checkout, keyed on a hash of the sources and flags, so an unchanged tree
reuses its library and an edited one rebuilds.

Every kernel wrapper launches through ``launch``: it makes the tensors'
card the current device for the call, passes that card's current stream,
raises on a launch error and counts the launch in ``LAUNCHES`` (one per
launch, nowhere else) so a run can show that its main path went through
the kernels.
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
    # The port's own kernels (no TPU counterpart): JAX's float32 angle chain
    # (csrc/angle.cu) and the BA's ordered segment sums (csrc/segment_sum.cu).
    "brisk_orientation": 0, "atan2f_elementwise": 0, "sincosf_elementwise": 0,
    "segment_sum": 0,
    # The gather probes' kernels: G1, G2, C, W (probes/gather.py); T, X, S
    # (probes/mosaic.py).
    "probe_take": 0, "probe_point_gather": 0, "probe_relayout": 0, "probe_window_copy": 0,
    "probe_transpose_chain": 0, "probe_gather_chain": 0, "probe_window_colsum": 0,
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


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
            lib.brisk_segment_sum.argtypes = [
                vp, vp, vp, vp,            # values, order, offsets, out
                ci, ci, ci, vp,            # segments, width, is_double, stream
            ]
            lib.brisk_segment_sum.restype = ci
            lib.brisk_error_string.argtypes = [ci]
            lib.brisk_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(entry: str, counter: str, device: torch.device, *args) -> None:
    """Launch the C entry point ``brisk_<entry>`` on card ``device``.

    The card is the current device for the call (a ctypes launch goes to
    the runtime's current device), the last argument is that card's
    current stream, a launch error raises, and ``LAUNCHES[counter]`` counts
    the launch.
    """
    if device.type != "cuda":
        raise ValueError(f"{entry}: launches need a CUDA device, got {device}")
    lib = library()
    with torch.cuda.device(device):
        err = getattr(lib, f"brisk_{entry}")(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = lib.brisk_error_string(err).decode()
        raise RuntimeError(f"{entry}: CUDA launch failed: error {err} ({msg})")
    LAUNCHES[counter] += 1
