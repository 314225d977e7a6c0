"""BRISK smoothed-intensity sampling (port of ``describe/fast_sampler.py`` and
``describe/pallas_sampler.py``).

For each (keypoint, pattern point) the value is the reference's
SmoothedIntensity x1024 (brisk-descriptor-extractor.cc:370-530), built
from a 6x6 grid of integral-image taps:

* ``_tap_geometry`` gives the grid's rows and columns and the box weight
  precursors (fast_sampler.py:51-101);
* the taps are read from the row-stacked int32 integral of the batch,
  each row shifted by the keypoint's ``row_base`` and every coordinate
  clipped to the frame-local bounds [0, frame_rows] x [0, cols];
* ``_values_from_taps`` weights them (fast_sampler.py:211-287).

Wherever all taps lie inside the frame (every describable keypoint) this
equals ``smoothed_intensity_u8`` and the TPU samplers bit for bit.

``v1_rounding`` is the v1 engine's rounding (brisk-v1.cc:246, :331, :366;
the JAX samplers' ``v1_rounding``): each division adds half its divisor
first, ``+ 512`` before ``// 1024`` in the small-sigma bilinear branch and
``+ max(scaling2, 1) // 2`` before ``// scaling2`` in the box branch, in
int32 with wrap-around as the sums are.

``smoothed_intensity`` is the plain torch version and
``smoothed_intensity_cuda`` launches kernel K2 (``csrc/sampler.cu``); the
pipeline calls ``smoothed_intensity_fused``, which picks by device.
"""
from __future__ import annotations

import torch

from ethzasl_brisk_tpu_torch import _kernels


def _trunc_i32(x: torch.Tensor) -> torch.Tensor:
    return torch.trunc(x).to(torch.int32)


def _tap_geometry(key_x, key_y, pat_x, pat_y, pat_sigma) -> dict:
    xf = pat_x + key_x[:, None]
    yf = pat_y + key_y[:, None]
    sigma_half = pat_sigma
    small = sigma_half < 0.5
    x_1 = xf - sigma_half
    x1 = xf + sigma_half
    y_1 = yf - sigma_half
    y1 = yf + sigma_half
    x_left = _trunc_i32(x_1 + 0.5)
    y_top = _trunc_i32(y_1 + 0.5)
    x_right = _trunc_i32(x1 + 0.5)
    y_bottom = _trunc_i32(y1 + 0.5)
    x_i = _trunc_i32(xf)
    y_i = _trunc_i32(yf)
    big = (x_right - x_left - 1) + (y_bottom - y_top - 1) > 2
    cd_y = torch.where(big, y_bottom - 1, y_bottom)
    c_x = torch.where(big, x_right + 1, x_right)
    d_x = torch.where(big, x_left + 1, x_left)
    rows_box6 = torch.stack([y_top, y_top + 1, cd_y, cd_y + 1, y_bottom, y_bottom + 1], -1)
    rows_small6 = torch.stack([y_i, y_i + 1, y_i + 2, y_i, y_i, y_i], -1)
    cols_box6 = torch.stack([x_left, x_left + 1, d_x + 1, x_right, x_right + 1, c_x + 1], -1)
    cols_small6 = torch.stack([x_i, x_i + 1, x_i + 2, x_i, x_i, x_i], -1)
    return dict(
        xf=xf, yf=yf, small=small, big=big,
        x_1=x_1, x1=x1, y_1=y_1, y1=y1,
        x_left=x_left, y_top=y_top, x_right=x_right, y_bottom=y_bottom,
        x_i=x_i, y_i=y_i,
        row_coords=torch.where(small[..., None], rows_small6, rows_box6),
        col_coords=torch.where(small[..., None], cols_small6, cols_box6),
    )


def _values_from_taps(taps, g, pat_scaling, pat_scaling2, v1_rounding=False) -> torch.Tensor:
    """(K, P, 6, 6) int32 taps -> (K, P) int32 values x1024.

    Grid rows: 0=y_top 1=y_top+1 2=cd_y 3=cd_y+1 4=y_bottom 5=y_bottom+1;
    columns: 0=x_left 1=x_left+1 2=d_x+1 3=x_right 4=x_right+1 5=c_x+1 (the
    small-sigma path uses rows/columns 0..2).
    """
    big = g["big"]

    def it(ri, ci):
        return taps[..., ri, ci]

    # Pixels img[y, x] = I[y+1, x+1] - I[y, x+1] - I[y+1, x] + I[y, x].
    img_a = it(1, 1) - it(0, 1) - it(1, 0) + it(0, 0)
    img_b = it(1, 4) - it(0, 4) - it(1, 3) + it(0, 3)
    img_c = it(3, 5) - it(2, 5) - torch.where(big, it(3, 4), it(3, 3)) + torch.where(
        big, it(2, 4), it(2, 3)
    )
    img_d = it(3, 2) - it(2, 2) - torch.where(big, it(3, 1), it(3, 0)) + torch.where(
        big, it(2, 1), it(2, 0)
    )

    r_x_1f = g["x_left"].to(torch.float32) - g["x_1"] + 0.5
    r_y_1f = g["y_top"].to(torch.float32) - g["y_1"] + 0.5
    r_x1f = g["x1"] - g["x_right"].to(torch.float32) + 0.5
    r_y1f = g["y1"] - g["y_bottom"].to(torch.float32) + 0.5
    scf = pat_scaling.to(torch.float32)
    # Corner/edge weights truncate float products to int (:436-443).
    w_a = _trunc_i32(r_x_1f * r_y_1f * scf)
    w_b = _trunc_i32(r_x1f * r_y_1f * scf)
    w_c = _trunc_i32(r_x1f * r_y1f * scf)
    w_d = _trunc_i32(r_x_1f * r_y1f * scf)
    r_x_1_i = _trunc_i32(r_x_1f * scf)
    r_y_1_i = _trunc_i32(r_y_1f * scf)
    r_x1_i = _trunc_i32(r_x1f * scf)
    r_y1_i = _trunc_i32(r_y1f * scf)

    corners = w_a * img_a + w_b * img_b + w_c * img_c + w_d * img_d
    t1, t2, t3, t4 = it(0, 1), it(0, 3), it(1, 3), it(1, 4)
    t5, t6, t7, t8 = it(4, 4), it(4, 3), it(5, 3), it(5, 1)
    t9, t10, t11, t12 = it(4, 1), it(4, 0), it(1, 0), it(1, 1)
    upper = (t3 - t2 + t1 - t12) * r_y_1_i
    middle = (t6 - t3 + t12 - t9) * pat_scaling
    left = (t9 - t12 + t11 - t10) * r_x_1_i
    right = (t5 - t4 + t3 - t6) * r_x1_i
    bottom = (t7 - t6 + t9 - t8) * r_y1_i
    total = corners + upper + middle + left + right + bottom
    scaling2 = torch.clamp(pat_scaling2, min=1)
    if v1_rounding:
        total = total + torch.div(scaling2, 2, rounding_mode="floor")
    box = torch.div(total, scaling2, rounding_mode="floor")

    # Small-sigma bilinear (:391-408).
    s00 = it(1, 1) - it(0, 1) - it(1, 0) + it(0, 0)
    s01 = it(1, 2) - it(0, 2) - it(1, 1) + it(0, 1)
    s10 = it(2, 1) - it(1, 1) - it(2, 0) + it(1, 0)
    s11 = it(2, 2) - it(1, 2) - it(2, 1) + it(1, 1)
    r_x = _trunc_i32((g["xf"] - g["x_i"].to(torch.float32)) * 1024)
    r_y = _trunc_i32((g["yf"] - g["y_i"].to(torch.float32)) * 1024)
    small_sum = (
        (1024 - r_x) * (1024 - r_y) * s00 + r_x * (1024 - r_y) * s01
        + r_x * r_y * s11 + (1024 - r_x) * r_y * s10
    )
    if v1_rounding:
        small_sum = small_sum + 512
    small_val = torch.div(small_sum, 1024, rounding_mode="floor")
    return torch.where(g["small"], small_val, box)


def smoothed_intensity(
    integral: torch.Tensor,      # (R, C+1) int32 row-stacked integrals
    key_x: torch.Tensor,         # (K,) f32, frame-local
    key_y: torch.Tensor,         # (K,) f32, frame-local
    pat_x: torch.Tensor,         # (K, P) f32 pattern offsets
    pat_y: torch.Tensor,         # (K, P) f32
    pat_sigma: torch.Tensor,     # (K, P) f32
    pat_scaling: torch.Tensor,   # (K, P) i32
    pat_scaling2: torch.Tensor,  # (K, P) i32
    row_base: torch.Tensor,      # (K,) i32 first integral row of the keypoint's frame
    frame_rows: int,             # frame height (its integral has frame_rows+1 rows)
    v1_rounding: bool = False,   # the v1 engine's half-divisor rounding
) -> torch.Tensor:
    """Plain version of kernel K2: (K, P) int32 smoothed intensities x1024."""
    cols = integral.shape[1] - 1
    g = _tap_geometry(key_x, key_y, pat_x, pat_y, pat_sigma)
    rows = torch.clamp(g["row_coords"], 0, frame_rows).to(torch.int64)
    rows = (rows + row_base.to(torch.int64)[:, None, None]) * (cols + 1)
    cols_c = torch.clamp(g["col_coords"], 0, cols).to(torch.int64)
    flat_idx = rows[..., :, None] + cols_c[..., None, :]  # (K, P, 6, 6)
    taps = integral.reshape(-1)[flat_idx]
    return _values_from_taps(taps, g, pat_scaling, pat_scaling2, v1_rounding)


def smoothed_intensity_cuda(
    integral, key_x, key_y, pat_x, pat_y, pat_sigma, pat_scaling, pat_scaling2,
    row_base, frame_rows: int, v1_rounding: bool = False,
) -> torch.Tensor:
    """Kernel K2: the same values as :func:`smoothed_intensity`, on the card.
    ``v1_rounding`` launches its v1 variant, counted as
    ``smoothed_intensity_v1``."""
    dev = integral.device
    if dev.type != "cuda":
        raise ValueError(f"smoothed_intensity_cuda needs CUDA tensors, got {dev}")
    k, p = pat_x.shape
    spec = [
        ("integral", integral, torch.int32, None),
        ("key_x", key_x, torch.float32, (k,)),
        ("key_y", key_y, torch.float32, (k,)),
        ("pat_x", pat_x, torch.float32, (k, p)),
        ("pat_y", pat_y, torch.float32, (k, p)),
        ("pat_sigma", pat_sigma, torch.float32, (k, p)),
        ("pat_scaling", pat_scaling, torch.int32, (k, p)),
        ("pat_scaling2", pat_scaling2, torch.int32, (k, p)),
        ("row_base", row_base, torch.int32, (k,)),
    ]
    for name, t, dt, shape in spec:
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dt} on {dev}, got {t.dtype} on {t.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if integral.dim() != 2:
        raise ValueError(f"integral: expected (R, C+1), got {tuple(integral.shape)}")
    if k * p >= 2**31 or (frame_rows + 1) * integral.shape[1] >= 2**31:
        raise ValueError("K2 takes fewer than 2^31 points and 2^31 ints a frame")
    out = torch.empty((k, p), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    args = (integral.data_ptr(), integral.shape[1] - 1, frame_rows,
            key_x.data_ptr(), key_y.data_ptr(),
            pat_x.data_ptr(), pat_y.data_ptr(), pat_sigma.data_ptr(),
            pat_scaling.data_ptr(), pat_scaling2.data_ptr(),
            row_base.data_ptr(), out.data_ptr(), k, p)
    if v1_rounding:
        _kernels.launch("smoothed_intensity", "smoothed_intensity_v1", dev, *args, 1)
    else:
        _kernels.launch("smoothed_intensity", "smoothed_intensity", dev, *args, 0)
    return out


def smoothed_intensity_fused(*args, **kwargs) -> torch.Tensor:
    """Kernel K2 for CUDA tensors, the plain version for CPU tensors."""
    if args[0].device.type == "cpu":
        return smoothed_intensity(*args, **kwargs)
    return smoothed_intensity_cuda(*args, **kwargs)
