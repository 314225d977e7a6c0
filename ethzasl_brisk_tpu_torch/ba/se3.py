"""Batched SO(3)/SE(3) Lie-group operations (port of ``ba/se3.py``).

Functions on tensors batched over leading axes, in the dtype of their
input. Both small-angle branches are evaluated and one is picked with
``torch.where``, as the JAX functions do, so forward-mode derivatives stay
finite at zero.

Conventions: rotations as 3x3 matrices; twists xi = (omega, v) with the
rotation block first; transforms as (R, t) pairs acting as x -> R x + t.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -w[..., 2], w[..., 1]], -1),
            torch.stack([w[..., 2], zeros, -w[..., 0]], -1),
            torch.stack([-w[..., 1], w[..., 0], zeros], -1),
        ],
        -2,
    )


def _eye_like(wx: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=wx.dtype, device=wx.device).expand(wx.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(w * w, -1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    wx = hat(w)
    return _eye_like(wx) + a[..., None, None] * wx + b[..., None, None] * (wx @ wx)


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3)."""
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    sin_t = torch.sin(theta)
    small = torch.abs(sin_t) < _EPS
    scale = torch.where(
        small, 0.5 + theta * theta / 12.0, theta / (2.0 * torch.clamp(sin_t, min=_EPS))
    )
    w = torch.stack(
        [r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0], r[..., 1, 0] - r[..., 0, 1]],
        -1,
    )
    return w * scale[..., None]


def _so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, -1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < _EPS
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2 * theta)
    )
    wx = hat(w)
    return _eye_like(wx) + b[..., None, None] * wx + c[..., None, None] * (wx @ wx)


def solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a x = b`` without a host sync: a singular ``a`` gives NaN, as the
    JAX solve gives a non-finite answer, where ``torch.linalg.solve``
    would raise."""
    x, info = torch.linalg.solve_ex(a, b)
    bad = (info != 0).reshape(*info.shape, *([1] * (x.dim() - info.dim())))
    return torch.where(bad, torch.full_like(x, float("nan")), x)


def se3_exp(xi: torch.Tensor):
    """(..., 6) twist (omega, v) -> (R (..., 3, 3), t (..., 3))."""
    w = xi[..., :3]
    v = xi[..., 3:]
    r = so3_exp(w)
    jl = _so3_left_jacobian(w)
    t = torch.einsum("...ij,...j->...i", jl, v)
    return r, t


def se3_log(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Inverse of se3_exp: -> (..., 6)."""
    w = so3_log(r)
    jl = _so3_left_jacobian(w)
    v = solve(jl, t[..., None])[..., 0]
    return torch.cat([w, v], -1)


def se3_compose(r1, t1, r2, t2):
    """(R1, t1) o (R2, t2): x -> R1 (R2 x + t2) + t1."""
    return r1 @ r2, torch.einsum("...ij,...j->...i", r1, t2) + t1


def se3_inverse(r, t):
    rt = torch.swapaxes(r, -1, -2)
    return rt, -torch.einsum("...ij,...j->...i", rt, t)
