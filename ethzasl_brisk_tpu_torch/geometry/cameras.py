"""Camera geometry: pinhole projection with pluggable distortion (port of
``geometry/cameras.py``).

Mirrors the reference camera stack (``brisk/include/brisk/cameras/``):
``PinholeCameraGeometry<DISTORTION_T>`` (pinhole-camera-geometry.h:16,
euclideanToKeypoint / keypointToEuclidean) and the distortion models
``NoDistortion``, ``RadialTangentialDistortion`` (k1, k2, p1, p2;
radial-tangential-distortion.h:19-31, undistort by 5 Gauss-Newton steps
:61-90) and ``EquidistantDistortion`` (the theta polynomial, an iterative
undistort). The methods take float32 tensors of points (..., 2) or
(..., 3) on any device; the parameters are float32, as in the JAX package
without x64, and the fixed-iteration loops are Python loops. The float ops
follow the JAX functions' order, so the results agree with JAX's to a few
ULP (its transcendental functions and fusion differ from torch's).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _f32(v) -> float:
    """A parameter as the float32 value the JAX package stores."""
    return float(np.float32(v))


def _c(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=like.device)


@dataclasses.dataclass(frozen=True)
class NoDistortion:
    """Identity distortion (no-distortion.h:17)."""

    def distort(self, p):
        return p

    def undistort(self, p):
        return p


@dataclasses.dataclass(frozen=True)
class RadialTangentialDistortion:
    """k1, k2 radial + p1, p2 tangential (radial-tangential-distortion.h)."""

    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    def __post_init__(self):
        for f in ("k1", "k2", "p1", "p2"):
            object.__setattr__(self, f, _f32(getattr(self, f)))

    def _params(self, like):
        return (_c(self.k1, like), _c(self.k2, like), _c(self.p1, like), _c(self.p2, like))

    def distort(self, p):
        k1, k2, p1, p2 = self._params(p)
        x, y = p[..., 0], p[..., 1]
        mx2 = x * x
        my2 = y * y
        mxy = x * y
        rho2 = mx2 + my2
        rad = k1 * rho2 + k2 * rho2 * rho2
        xd = x + x * rad + 2.0 * p1 * mxy + p2 * (rho2 + 2.0 * mx2)
        yd = y + y * rad + 2.0 * p2 * mxy + p1 * (rho2 + 2.0 * my2)
        return torch.stack([xd, yd], dim=-1)

    def undistort(self, p, iterations: int = 5):
        """Gauss-Newton inversion, a fixed number of steps (the reference's 5)."""
        ybar = p
        for _ in range(iterations):
            # Solve J dy = distort(ybar) - p with the exact 2x2 Jacobian.
            e = self.distort(ybar) - p
            j = self.distort_jacobian(ybar)
            det = j[..., 0, 0] * j[..., 1, 1] - j[..., 0, 1] * j[..., 1, 0]
            det = torch.where(det == 0, torch.ones_like(det), det)
            dx = (j[..., 1, 1] * e[..., 0] - j[..., 0, 1] * e[..., 1]) / det
            dy = (-j[..., 1, 0] * e[..., 0] + j[..., 0, 0] * e[..., 1]) / det
            ybar = ybar - torch.stack([dx, dy], dim=-1)
        return ybar

    def distort_jacobian(self, p):
        """d(distort)/d(point), (..., 2, 2) (radial-tangential-distortion.h:34-58)."""
        k1, k2, p1, p2 = self._params(p)
        x, y = p[..., 0], p[..., 1]
        mx2 = x * x
        my2 = y * y
        rho2 = mx2 + my2
        j00 = (1.0 + k1 * rho2 + k2 * rho2 * rho2 + 2.0 * k1 * mx2
               + 4.0 * k2 * rho2 * mx2 + 2.0 * p1 * y + 6.0 * p2 * x)
        j11 = (1.0 + k1 * rho2 + k2 * rho2 * rho2 + 2.0 * k1 * my2
               + 4.0 * k2 * rho2 * my2 + 2.0 * p2 * x + 6.0 * p1 * y)
        j01 = 2.0 * k1 * x * y + 4.0 * k2 * rho2 * x * y + 2.0 * p1 * x + 2.0 * p2 * y
        return torch.stack([torch.stack([j00, j01], dim=-1), torch.stack([j01, j11], dim=-1)],
                           dim=-2)


@dataclasses.dataclass(frozen=True)
class EquidistantDistortion:
    """Equidistant (fisheye) model k1..k4 (equidistant-distortion.h:17):
    theta = atan(r), theta_d = theta (1 + k1 t^2 + k2 t^4 + k3 t^6 +
    k4 t^8), scale = theta_d / r; undistort by Newton steps on theta."""

    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0

    def __post_init__(self):
        for f in ("k1", "k2", "k3", "k4"):
            object.__setattr__(self, f, _f32(getattr(self, f)))

    def _theta_d(self, theta):
        k1, k2, k3, k4 = (_c(getattr(self, f), theta) for f in ("k1", "k2", "k3", "k4"))
        t2 = theta * theta
        return theta * (1.0 + k1 * t2 + k2 * t2 * t2 + k3 * t2 * t2 * t2
                        + k4 * t2 * t2 * t2 * t2)

    def distort(self, p):
        x, y = p[..., 0], p[..., 1]
        r = torch.sqrt(x * x + y * y)
        r_safe = torch.where(r < 1e-8, torch.ones_like(r), r)
        theta = torch.arctan(r)
        scaling = torch.where(r < 1e-8, torch.ones_like(r), self._theta_d(theta) / r_safe)
        return p * scaling[..., None]

    def undistort(self, p, iterations: int = 20):
        k1, k2, k3, k4 = (_c(getattr(self, f), p) for f in ("k1", "k2", "k3", "k4"))
        x, y = p[..., 0], p[..., 1]
        theta_d = torch.sqrt(x * x + y * y)
        theta = theta_d
        for _ in range(iterations):
            # Newton on theta_d(theta) = theta_d.
            t2 = theta * theta
            f = self._theta_d(theta) - theta_d
            df = (1.0 + 3.0 * k1 * t2 + 5.0 * k2 * t2 * t2 + 7.0 * k3 * t2 * t2 * t2
                  + 9.0 * k4 * t2 * t2 * t2 * t2)
            theta = theta - f / torch.where(df == 0, torch.ones_like(df), df)
        r = torch.tan(theta)
        td_safe = torch.where(theta_d < 1e-8, torch.ones_like(theta_d), theta_d)
        scaling = torch.where(theta_d < 1e-8, torch.ones_like(r), r / td_safe)
        return p * scaling[..., None]


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    """Pinhole camera with distortion (pinhole-camera-geometry.h): focal
    lengths fu, fv, principal point cu, cv (float32 values), the image size
    width x height, and a distortion model."""

    fu: float
    fv: float
    cu: float
    cv: float
    width: int
    height: int
    distortion: object = dataclasses.field(default_factory=NoDistortion)

    def __post_init__(self):
        for f in ("fu", "fv", "cu", "cv"):
            object.__setattr__(self, f, _f32(getattr(self, f)))
        object.__setattr__(self, "width", int(self.width))
        object.__setattr__(self, "height", int(self.height))
        if self.distortion is None:
            object.__setattr__(self, "distortion", NoDistortion())

    def _intrinsics(self, like):
        return (_c(self.fu, like), _c(self.fv, like), _c(self.cu, like), _c(self.cv, like))

    def project(self, p_c):
        """(..., 3) camera-frame points -> ((..., 2) pixels, valid mask)
        (euclideanToKeypoint: normalise by z, distort, apply the
        intrinsics; valid = inside the image and z > 0)."""
        fu, fv, cu, cv = self._intrinsics(p_c)
        z = p_c[..., 2]
        rz = 1.0 / torch.where(z == 0, torch.ones_like(z), z)
        pn = torch.stack([p_c[..., 0] * rz, p_c[..., 1] * rz], dim=-1)
        pd = self.distortion.distort(pn)
        kp = torch.stack([fu * pd[..., 0] + cu, fv * pd[..., 1] + cv], dim=-1)
        return kp, self.is_valid(kp) & (z > 0)

    def unproject(self, kp):
        """(..., 2) pixels -> (..., 3) unit-norm rays (keypointToEuclidean)."""
        fu, fv, cu, cv = self._intrinsics(kp)
        xn = (kp[..., 0] - cu) / fu
        yn = (kp[..., 1] - cv) / fv
        pu = self.distortion.undistort(torch.stack([xn, yn], dim=-1))
        ray = torch.stack([pu[..., 0], pu[..., 1], torch.ones_like(pu[..., 0])], dim=-1)
        return ray / torch.linalg.vector_norm(ray, dim=-1, keepdim=True)

    def is_valid(self, kp):
        """The in-image predicate (isValid)."""
        return ((kp[..., 0] >= 0) & (kp[..., 0] < self.width)
                & (kp[..., 1] >= 0) & (kp[..., 1] < self.height))

    def project_jacobian(self, p_c):
        """d(pixel)/d(point), (..., 2, 3), by forward-mode differentiation of
        ``project`` (the JAX package's ``jax.jacfwd``): one batched
        Jacobian-vector product per coordinate of the points, each point's
        its own."""
        from torch.func import jvp

        cols = []
        for j in range(3):
            tangent = torch.zeros_like(p_c)
            tangent[..., j] = 1.0
            cols.append(jvp(lambda q: self.project(q)[0], (p_c,), (tangent,))[1])
        return torch.stack(cols, dim=-1)
