"""Sub-pixel 2-D quadratic refinement (port of ``detect/subpixel.py``).

Reference: ``ScaleSpaceLayer::Subpixel2D``
(scale-space-layer-inl.h:560-693): a least-squares quadratic fit over the
3x3 score patch with a Hessian test, a corner fallback and boundary
clamping (including the reference's ``delta_y = delta_x{1,2}`` in the
boundary branch). Every float op is its own torch op, so each rounds
separately, as in the reference's scalar C++ and the JAX package's eager
path.

The patches may be float32 or float64 (``refine_dtype="float64"``, the
reference's double). As in the reference and the JAX package, the
interior and boundary deltas are float divisions of float casts and the
boundary maxima are rounded to float, so with float64 patches the deltas
are float32 values carried in float64. Divisions by a constant that is not
a power of two divide by a tensor: on the card a division by a Python
number is a multiplication by its reciprocal, which rounds differently.
"""
from __future__ import annotations

import torch


def _f32(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.float32)


def _div(v: torch.Tensor, c: float) -> torch.Tensor:
    """v / c rounded once, on either device."""
    return v / torch.full((), c, dtype=v.dtype, device=v.device)


def subpixel2d(s: torch.Tensor):
    """(..., 3, 3) float32 or float64 patches, s[..., i, j] =
    score(x + j - 1, y + i - 1) -> (delta_x, delta_y, refined_max), each
    (...,) in the patches' dtype."""
    s_0_0, s_0_1, s_0_2 = s[..., 0, 0], s[..., 0, 1], s[..., 0, 2]
    s_1_0, s_1_1, s_1_2 = s[..., 1, 0], s[..., 1, 1], s[..., 1, 2]
    s_2_0, s_2_1, s_2_2 = s[..., 2, 0], s[..., 2, 1], s[..., 2, 2]

    tmp1 = s_0_0 + s_0_2 - 2 * s_1_1 + s_2_0 + s_2_2
    coeff1 = 3 * (tmp1 + s_0_1 - ((s_1_0 + s_1_2) / 2.0) + s_2_1)
    coeff2 = 3 * (tmp1 - ((s_0_1 + s_2_1) / 2.0) + s_1_0 + s_1_2)
    tmp2 = s_0_2 - s_2_0
    tmp3 = s_0_0 + tmp2 - s_2_2
    tmp4 = tmp3 - 2 * tmp2
    coeff3 = -3 * (tmp3 + s_0_1 - s_2_1)
    coeff4 = -3 * (tmp4 + s_1_0 - s_1_2)
    coeff5 = (s_0_0 - s_0_2 - s_2_0 + s_2_2) / 4.0
    coeff6 = _div(
        -(
            s_0_0
            + s_0_2
            - ((s_1_0 + s_0_1 + s_1_2 + s_2_1) / 2.0)
            - 5 * s_1_1
            + s_2_0
            + s_2_2
        ),
        2.01,
    )
    h_det = 4 * coeff1 * coeff2 - coeff5 * coeff5

    one = torch.ones_like(coeff1)
    zero = torch.zeros_like(coeff1)

    # Corner fallback: the reference truncates corner values to int and
    # keeps the first maximum in its check order (:590-611).
    corner_vals_i = torch.trunc(
        torch.stack(
            [
                coeff3 + coeff4 + coeff5,
                -coeff3 + coeff4 - coeff5,
                coeff3 - coeff4 - coeff5,
                -coeff3 - coeff4 + coeff5,
            ],
            dim=-1,
        )
    )
    corner_idx = torch.argmax(
        torch.cat([corner_vals_i[..., :1], corner_vals_i[..., 1:] - 0.5], dim=-1),
        dim=-1,
        keepdim=True,
    )
    corner_dx = torch.stack([one, -one, one, -one], dim=-1)
    corner_dy = torch.stack([one, one, -one, -one], dim=-1)
    corner_tmp_max = torch.gather(corner_vals_i, -1, corner_idx)[..., 0]
    b_dx = torch.gather(corner_dx, -1, corner_idx)[..., 0]
    b_dy = torch.gather(corner_dy, -1, corner_idx)[..., 0]
    b_max = _div(corner_tmp_max + coeff1 + coeff2 + coeff6, 18.0)

    # Interior solution with boundary correction (:616-687): float
    # divisions of float casts.
    safe_det = _f32(torch.where(h_det == 0, one, h_det))
    dx0 = _f32(2 * coeff2 * coeff3 - coeff4 * coeff5) / (-safe_det)
    dy0 = _f32(2 * coeff1 * coeff4 - coeff3 * coeff5) / (-safe_det)
    tx, tx_ = dx0 > 1.0, dx0 < -1.0
    ty, ty_ = dy0 > 1.0, dy0 < -1.0
    out_of_bounds = tx | tx_ | ty | ty_

    # Guards keep discarded lanes finite; selected lanes have nonzero
    # divisors (the branch needs h_det > 0 and coeff1 < 0, so coeff2 < 0).
    div_c1 = _f32(torch.where(coeff1 == 0, one, 2 * coeff1))
    div_c2 = _f32(torch.where(coeff2 == 0, one, 2 * coeff2))
    one32, zero32 = _f32(one), _f32(zero)

    delta_x1 = torch.where(tx, one32, torch.where(tx_, -one32, zero32))
    delta_y1 = torch.where(
        tx, -_f32(coeff4 + coeff5) / div_c2,
        torch.where(tx_, -_f32(coeff4 - coeff5) / div_c2, zero32),
    ).clamp(-1.0, 1.0)
    delta_y2 = torch.where(ty, one32, torch.where(ty_, -one32, zero32))
    delta_x2 = torch.where(
        ty, -_f32(coeff3 + coeff5) / div_c1,
        torch.where(ty_, -_f32(coeff3 - coeff5) / div_c1, zero32),
    ).clamp(-1.0, 1.0)

    def quad(dx, dy):
        # The patches' precision over float deltas (:672-679).
        return _div(
            coeff1 * dx * dx
            + coeff2 * dy * dy
            + coeff3 * dx
            + coeff4 * dy
            + coeff5 * dx * dy
            + coeff6,
            18.0,
        )

    # Rounded to float on assignment to max1, max2.
    max1 = _f32(quad(delta_x1, delta_y1))
    max2 = _f32(quad(delta_x2, delta_y2))
    pick1 = max1 > max2
    # Faithful to the reference: both deltas take delta_x{1,2} (:679-687).
    bnd_d = torch.where(pick1, delta_x1, delta_x2)
    bnd_max = torch.where(pick1, max1, max2)

    c_dx = torch.where(out_of_bounds, bnd_d, dx0)
    c_dy = torch.where(out_of_bounds, bnd_d, dy0)
    c_max = torch.where(out_of_bounds, bnd_max, quad(dx0, dy0))

    is_zero = h_det == 0
    is_corner = ~(h_det > 0) | ~(coeff1 < 0)
    delta_x = torch.where(is_zero, zero, torch.where(is_corner, b_dx, c_dx))
    delta_y = torch.where(is_zero, zero, torch.where(is_corner, b_dy, c_dy))
    refined = torch.where(is_zero, _div(coeff6, 18.0), torch.where(is_corner, b_max, c_max))
    return delta_x, delta_y, refined
