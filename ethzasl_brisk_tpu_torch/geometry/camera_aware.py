"""Camera-aware feature extraction through virtual undistorted views (port
of ``geometry/camera_aware.py``).

Mirrors ``brisk::CameraAwareFeature`` (``brisk/include/brisk/
camera-aware-feature.h:50-116``, ``brisk/src/camera-aware-feature.cc``):
for a distorted camera, an N_x x N_y grid of virtual undistorted pinhole
views (the grid size from the corner rays' angles and a distortion
tolerance, camera-aware-feature.cc:98-114). Keypoints are DETECTED on the
distorted image, assigned to a view by a model-selection map (:567-583),
DESCRIBED in that view's undistorted warp, and their angles mapped back
through the distort maps (:660-672). Both angle sites take the JAX
package's float32 ``atan2`` and the back-transform its ``sin`` and ``cos``
(glibc's, ``core/atan2f.py`` and ``core/sincosf.py``). Each site is one
walk (``walk_angles``): the plain torch chain ``walk_angles_plain`` on the
CPU, kernel ``walk_angles`` (``csrc/angle.cu``), the whole chain of a
keypoint in one thread, on the card.

The views are built once on the host (NumPy over this package's cameras,
``_build_views``); the grid's tables then live on its device: the distort
maps (view pixel -> real pixel), the undistort maps (real pixel -> view
pixel), the selection map, the rotations and the view sizes, every view
padded to a common shape. ``install_tables`` puts tables built elsewhere
(the JAX grid's, as numpy arrays) in their place. A call warps every view
with one batched bilinear gather and describes every view's keypoints in
one call of ``extract_descriptors_views`` (kernel K2 twice).

``CameraAwareFeature`` is the single-virtual-view variant: detect and
describe in one undistorted warp, keypoints mapped back to the image.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ethzasl_brisk_tpu_torch import _kernels
from ethzasl_brisk_tpu_torch.core.atan2f import atan2f
from ethzasl_brisk_tpu_torch.core.device import resolve_device
from ethzasl_brisk_tpu_torch.core.sincosf import sincosf
from ethzasl_brisk_tpu_torch.describe.extractor import extract_descriptors_views
from ethzasl_brisk_tpu_torch.geometry.cameras import PinholeCamera

f32 = torch.float32
DEG_PER_RAD = 180.0 / math.pi


def bilinear_remap(img: torch.Tensor, src_x: torch.Tensor, src_y: torch.Tensor) -> torch.Tensor:
    """uint8 (H, W) image sampled at float32 maps (..., h, w) -> uint8
    (..., h, w): bilinear, rounded half up, 0 where the source lies outside
    [0, W-1] x [0, H-1]."""
    h, w = img.shape
    x0 = torch.clamp(torch.floor(src_x).to(torch.int32), 0, w - 2)
    y0 = torch.clamp(torch.floor(src_y).to(torch.int32), 0, h - 2)
    fx = torch.clamp(src_x - x0, 0.0, 1.0)
    fy = torch.clamp(src_y - y0, 0.0, 1.0)
    im = img.to(f32).reshape(-1)
    idx = y0.to(torch.int64) * w + x0.to(torch.int64)
    v00, v01 = im[idx], im[idx + 1]
    v10, v11 = im[idx + w], im[idx + w + 1]
    out = (1 - fy) * ((1 - fx) * v00 + fx * v01) + fy * ((1 - fx) * v10 + fx * v11)
    inside = (src_x >= 0) & (src_x <= w - 1) & (src_y >= 0) & (src_y <= h - 1)
    return torch.where(inside, out + 0.5, 0.0).to(torch.uint8)


def _bilerp_maps(maps, vidx, x, y):
    """Maps (V, H, W, 2) at float (x, y) in view ``vidx``, bilinear
    (distortPoint/undistortPoint, camera-aware-feature.cc:713-760: the
    truncated corner, clamped here to stay in the map)."""
    hh, ww = maps.shape[1], maps.shape[2]
    xi = torch.clamp(x.to(torch.int32), 0, ww - 2)
    yi = torch.clamp(y.to(torch.int32), 0, hh - 2)
    rx = (x - xi)[..., None]
    ry = (y - yi)[..., None]
    v, yl, xl = vidx.to(torch.int64), yi.to(torch.int64), xi.to(torch.int64)
    p00, p10 = maps[v, yl, xl], maps[v, yl, xl + 1]
    p01, p11 = maps[v, yl + 1, xl], maps[v, yl + 1, xl + 1]
    px0 = p00 + rx * (p10 - p00)
    px1 = p01 + rx * (p11 - p01)
    return px0 + ry * (px1 - px0)


def walk_angles_plain(maps, vidx, base_x, base_y, size, ref_x, ref_y, angle=None,
                      direction=None):
    """The angle in degrees, seen from (ref_x, ref_y), of the point that a
    walk of ``size`` from (base_x, base_y) reaches, looked up in view
    ``vidx`` of ``maps`` (V, H, W, 2). The walk goes along the view angle
    ``angle`` (degrees) or along ``direction``, an (x, y) pair. Float32
    (K,) tensors, ``vidx`` int32: the grid's two angle sites as torch ops,
    glibc's ``sincosf`` and ``atan2f`` (cc:607-632, :660-672)."""
    if angle is not None:
        a_rad = angle * (math.pi / 180.0)
        dir_y, dir_x = sincosf(a_rad)
    else:
        dir_x, dir_y = direction
    end = _bilerp_maps(maps, vidx, base_x + size * dir_x, base_y + size * dir_y)
    return atan2f(end[..., 1] - ref_y, end[..., 0] - ref_x) * DEG_PER_RAD


def walk_angles_cuda(maps, vidx, base_x, base_y, size, ref_x, ref_y, angle=None,
                     direction=None):
    """Kernel ``walk_angles``: :func:`walk_angles_plain` on the card, one
    launch. The (K,) inputs may be strided views (the x and y columns of
    an (K, 2) tensor)."""
    if (angle is None) == (direction is None):
        raise ValueError("walk_angles takes an angle or a direction")
    dev = maps.device
    if dev.type != "cuda":
        raise ValueError(f"walk_angles_cuda needs CUDA tensors, got {dev}")
    steps = (angle, angle) if direction is None else tuple(direction)
    vecs = (base_x, base_y, size, *steps, ref_x, ref_y)
    n = vidx.shape[0] if vidx.dim() == 1 else -1
    for t in vecs:
        if t.device != dev or t.dtype != f32 or t.dim() != 1 or t.shape[0] != n:
            raise ValueError("walk_angles takes float32 (K,) tensors on the maps' card")
    if (maps.dtype != f32 or maps.dim() != 4 or maps.shape[3] != 2 or not maps.is_contiguous()
            or vidx.device != dev or vidx.dtype != torch.int32 or not vidx.is_contiguous()):
        raise ValueError("walk_angles takes contiguous float32 (V, H, W, 2) maps and an int32 "
                         "(K,) view index on one card")
    out = torch.empty(n, dtype=f32, device=dev)
    if n:
        args = [a for t in vecs for a in (t.data_ptr(), t.stride(0))]
        _kernels.launch("walk_angles", "walk_angles", dev, maps.data_ptr(), maps.shape[1],
                        maps.shape[2], vidx.data_ptr(), *args, out.data_ptr(), n,
                        int(direction is None))
    return out


def walk_angles(maps, vidx, base_x, base_y, size, ref_x, ref_y, angle=None, direction=None):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = walk_angles_plain if maps.device.type == "cpu" else walk_angles_cuda
    return fn(maps, vidx, base_x, base_y, size, ref_x, ref_y, angle=angle, direction=direction)


def _distort_pixels(camera: PinholeCamera, vcam: PinholeCamera, x, y):
    """Virtual pixel -> normalised ray -> distort -> real pixel."""
    xn = (x - vcam.cu) / torch.full((), vcam.fu, dtype=f32, device=x.device)
    yn = (y - vcam.cv) / torch.full((), vcam.fv, dtype=f32, device=x.device)
    pd = camera.distortion.distort(torch.stack([xn, yn], dim=-1))
    return camera.fu * pd[..., 0] + camera.cu, camera.fv * pd[..., 1] + camera.cv


@dataclasses.dataclass
class CameraAwareFeature:
    """Detect and describe through one virtual undistorted pinhole view
    (focal lengths scaled by ``virtual_fov_scale``), on the feature's
    device."""

    camera: PinholeCamera
    feature: object
    virtual_fov_scale: float = 1.0

    def _virtual_camera(self) -> PinholeCamera:
        c = self.camera
        return PinholeCamera(c.fu * self.virtual_fov_scale, c.fv * self.virtual_fov_scale,
                             c.cu, c.cv, c.width, c.height)

    def warp_maps(self):
        """(src_x, src_y), each (H, W) float32: virtual pixel -> real
        (distorted) pixel."""
        c = self.camera
        dev = self.feature.device
        ys, xs = torch.meshgrid(torch.arange(c.height, device=dev),
                                torch.arange(c.width, device=dev), indexing="ij")
        return _distort_pixels(c, self._virtual_camera(), xs.to(f32), ys.to(f32))

    def detect_and_compute(self, img: torch.Tensor):
        """Detect and describe in the undistorted view of one (H, W) uint8
        image. Returns (keypoints mapped back to the distorted image, the
        view's descriptors, the warped view)."""
        src_x, src_y = self.warp_maps()
        warped = bilinear_remap(img.to(src_x.device), src_x, src_y)
        kps, desc = self.feature.detect_and_compute(warped)
        # Keypoints back to the real image (distortKeypoints,
        # camera-aware-feature.cc:768).
        c = self.camera
        x_real, y_real = _distort_pixels(c, self._virtual_camera(), kps.x, kps.y)
        inside = (x_real >= 0) & (x_real < c.width) & (y_real >= 0) & (y_real < c.height)
        out = dataclasses.replace(kps, x=x_real, y=y_real, valid=kps.valid & inside)
        return out, desc, warped


def _rodrigues(rvec: np.ndarray) -> np.ndarray:
    """Rotation matrix of a rotation vector (cv::Rodrigues: angle |rvec|,
    axis rvec / |rvec|)."""
    theta = float(np.linalg.norm(rvec))
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    kk = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * kk + (1 - np.cos(theta)) * (kk @ kk)


def _three_plane_intersection(n1, n2, n3, d=-1.0):
    """The intersection of the planes n_i . x + d = 0
    (threePlaneIntersection, camera-aware-feature.cc:390-404)."""
    denom = float(np.dot(n1, np.cross(n2, n3)))
    if abs(denom) < 1e-12:
        return None
    return (np.cross(n2, n3) * d + np.cross(n3, n1) * d + np.cross(n1, n2) * d) / (-denom)


@dataclasses.dataclass(frozen=True)
class ViewGeometry:
    """One virtual pinhole view's host constants."""

    r_ci_c: np.ndarray   # (3, 3) rays C -> Ci
    center_u: float
    center_v: float
    pixels_u: int
    pixels_v: int
    lo_u: float          # the model-selection region (margins excluded)
    hi_u: float
    lo_v: float
    hi_v: float


TABLE_FIELDS = ("dist_maps", "undist_maps", "sel_map", "n_x", "n_y", "focal", "r_ci_c",
                "view_cols", "view_rows")


class CameraAwareFeatureGrid:
    """The grid of virtual views: detect on the distorted image, describe
    in the views, angles mapped back (camera-aware-feature.cc:44-341 set-up,
    :430-700 detectAndCompute).

    ``feature`` is a ``BriskFeature`` on ``device`` (the card unless
    ``device="cpu"``), where the grid's tables live too.
    ``extraction_direction`` (setExtractionDirection,
    camera-aware-feature.h:36) replaces BRISK's own orientation with a
    fixed 3-D direction projected at each keypoint. ``tables`` (a dict of
    ``TABLE_FIELDS``) installs tables built elsewhere instead of building
    the views (``install_tables``).

    As the JAX grid, it describes with the feature's pattern and keywords
    but not its ``angle_exact`` or v1 rounding.
    """

    def __init__(self, camera: PinholeCamera, feature, distortion_tolerance: float = 2e-1,
                 margin: int = 100, extraction_direction: tuple | None = None,
                 device: str | torch.device = "cuda", tables: dict | None = None):
        self.device = resolve_device(device)
        if feature.device != self.device:
            raise ValueError(f"the feature runs on {feature.device}, the grid on {self.device}: "
                             "build both with the same device")
        self.camera = camera
        self.feature = feature
        self.distortion_tolerance = distortion_tolerance
        self.margin = margin
        self.extraction_direction = extraction_direction
        self.views: list[ViewGeometry] | None = None
        if tables is None:
            self.views, tables = self._build_views()
        self.install_tables(**tables)

    def install_tables(self, *, dist_maps, undist_maps, sel_map, n_x, n_y, focal, r_ci_c,
                       view_cols, view_rows) -> None:
        """Put host tables (numpy) on the grid's device: the distort maps
        (V, maxPV, maxPU, 2) view pixel -> real pixel, the undistort maps
        (V, H, W, 2) real pixel -> view pixel, the selection map (H, W)
        int32 (0 unassigned, else view index + 1), the grid size, the
        focal length, the rotations (V, 3, 3) and each view's size."""
        dev = self.device
        self.n_x, self.n_y, self.focal = int(n_x), int(n_y), float(focal)
        self.dist_maps = torch.from_numpy(np.array(dist_maps, np.float32)).to(dev)
        self.undist_maps = torch.from_numpy(np.array(undist_maps, np.float32)).to(dev)
        self.sel_map = torch.from_numpy(np.array(sel_map, np.int32)).to(dev)
        self.r_ci_c = torch.from_numpy(np.array(r_ci_c, np.float32)).to(dev)
        self.view_cols = torch.from_numpy(np.array(view_cols, np.int32)).to(dev)
        self.view_rows = torch.from_numpy(np.array(view_rows, np.int32)).to(dev)

    @property
    def n_views(self) -> int:
        return int(self.view_cols.shape[0])

    # ---- host set-up (numpy; setCameraGeometry) ----

    def _unproject_np(self, pts) -> np.ndarray:
        rays = self.camera.unproject(torch.from_numpy(np.asarray(pts, np.float32)))
        return rays.numpy().astype(np.float64)

    def _build_views(self):
        cam = self.camera
        w, h = cam.width, cam.height
        p00, pw0, p0h, pwh = self._unproject_np(
            [[0.0, 0.0], [w, 0.0], [0.0, h], [float(w), float(h)]])

        def ang(a, b):
            return float(np.arccos(np.clip(np.dot(a, b), -1, 1)))

        angle_x = max(ang(p00, pw0), ang(p0h, pwh))
        angle_y = max(ang(p00, p0h), ang(pw0, pwh))
        n_x = int(angle_x / 2.0 / self.distortion_tolerance + 1.0)
        n_y = int(angle_y / 2.0 / self.distortion_tolerance + 1.0)
        pmc, ppc = self._unproject_np([[w / 2.0 - 1.0, h / 2.0], [w / 2.0 + 1.0, h / 2.0]])
        focal = 1.0 / ((ppc[0] / ppc[2] - pmc[0] / pmc[2]) / 2.0)

        # Cell-center normals (camera-aware-feature.cc:131-149), i = m + n*n_x.
        normals = self._unproject_np(
            [[w / (2.0 * n_x) + m * w / n_x, h / (2.0 * n_y) + n * h / n_y]
             for n in range(n_y) for m in range(n_x)])
        left_rays = self._unproject_np(np.stack([np.zeros(h), np.arange(h, dtype=np.float64)], 1))
        right_rays = self._unproject_np(np.stack([np.full(h, float(w)), np.arange(h) * 1.0], 1))
        top_rays = self._unproject_np(np.stack([np.arange(w, dtype=np.float64), np.zeros(w)], 1))
        bottom_rays = self._unproject_np(np.stack([np.arange(w) * 1.0, np.full(w, float(h))], 1))

        views = []
        for n in range(n_y):
            for m in range(n_x):
                views.append(self._view(normals, m, n, n_x, n_y, focal,
                                        (left_rays, right_rays, top_rays, bottom_rays)))

        # The dense maps, padded to a common shape.
        max_pu = max(v.pixels_u for v in views)
        max_pv = max(v.pixels_v for v in views)
        dist_maps = np.zeros((len(views), max_pv, max_pu, 2), np.float32)
        undist_maps = np.zeros((len(views), h, w, 2), np.float32)
        sel = np.zeros((h, w), np.int32)
        ys, xs = np.mgrid[0:max_pv, 0:max_pu].astype(np.float64)
        real_rays = self._unproject_np(
            np.stack(np.mgrid[0:w, 0:h], -1).reshape(-1, 2).astype(np.float64)
        ).reshape(w, h, 3).transpose(1, 0, 2)  # (H, W, 3)
        for i, v in enumerate(views):
            # Distort map: view pixel -> ray in C -> real pixel, through the
            # camera's own projection (euclideanToKeypoint; cc:330-344).
            rays_ci = np.stack([(xs - v.center_u) / focal, (ys - v.center_v) / focal,
                                np.ones_like(xs)], -1)
            rays_c = rays_ci @ v.r_ci_c
            kp, _ = cam.project(torch.from_numpy(rays_c.astype(np.float32)))
            dist_maps[i] = kp.numpy()
            # Undistort map: real pixel ray -> view pinhole (cc:350-363).
            p_ci = real_rays @ v.r_ci_c.T
            undist_maps[i, ..., 0] = p_ci[..., 0] / p_ci[..., 2] * focal + v.center_u
            undist_maps[i, ..., 1] = p_ci[..., 1] / p_ci[..., 2] * focal + v.center_v
            # Model selection (cc:370-384): the highest view index whose
            # region without margins covers the real pixel.
            u, vv = undist_maps[i, ..., 0], undist_maps[i, ..., 1]
            inside = ((u >= v.lo_u) & (u <= v.hi_u - 1.0) & (vv >= v.lo_v)
                      & (vv <= v.hi_v - 1.0) & (p_ci[..., 2] > 0))
            sel = np.where(inside, i + 1, sel)
        tables = dict(dist_maps=dist_maps, undist_maps=undist_maps, sel_map=sel, n_x=n_x,
                      n_y=n_y, focal=focal, r_ci_c=np.stack([v.r_ci_c for v in views]),
                      view_cols=[v.pixels_u for v in views],
                      view_rows=[v.pixels_v for v in views])
        return views, tables

    def _view(self, normals, m, n, n_x, n_y, focal, border_rays) -> ViewGeometry:
        """Grid cell (m, n)'s view: its rotation, its corners from the
        neighbours' planes and the traced image border, its size and
        principal point."""
        i = m + n * n_x
        r_ci_c = _rodrigues(np.cross(normals[i], [0.0, 0.0, 1.0]))
        left, right = m == 0, m == n_x - 1
        top, bottom = n == 0, n == n_y - 1
        p = {k: np.zeros(3) for k in ("00", "10", "01", "11")}

        # Interior corners: three-plane intersections of the unit planes
        # n.x = 1 with the neighbours' (cc:180-215), rotated into the view
        # and normalised to z = 1.
        def corner(key, na, nb):
            q = _three_plane_intersection(normals[i], na, nb)
            if q is None:
                return
            q = r_ci_c @ q
            p[key] = np.array([q[0] / q[2], q[1] / q[2], 1.0])

        if not left and not top:
            corner("00", normals[i - 1], normals[i - n_x])
        if not top and not right:
            corner("10", normals[i - n_x], normals[i + 1])
        if not left and not bottom:
            corner("01", normals[i - 1], normals[i + n_x])
        if not right and not bottom:
            corner("11", normals[i + 1], normals[i + n_x])

        # Border traces (cc:221-290): extend the open sides over the traced
        # image border, keeping the candidates inside the extents fixed so
        # far; x first (left, right), then y (top, bottom), as the reference.
        def trace(rays, axis, cmp, keys, guard_axis, guards):
            pts = (r_ci_c @ rays.T).T
            pts = pts[:, :2] / pts[:, 2:3]
            keep = np.ones(len(pts), bool)
            for g_keys, g_cmp in guards:
                bound = (min if g_cmp == "<" else max)(p[g_keys[0]][guard_axis],
                                                       p[g_keys[1]][guard_axis])
                keep &= pts[:, guard_axis] >= bound if g_cmp == "<" else pts[:, guard_axis] <= bound
            if not keep.any():
                return
            ext = (min if cmp == "<" else max)(pts[keep, axis])
            for key in keys:
                if (cmp == "<" and ext < p[key][axis]) or (cmp == ">" and ext > p[key][axis]):
                    p[key][axis] = ext

        left_rays, right_rays, top_rays, bottom_rays = border_rays
        guards_y = ([(("00", "10"), "<")] if not top else []) + (
            [(("01", "11"), ">")] if not bottom else [])
        guards_x = ([(("00", "01"), "<")] if not left else []) + (
            [(("10", "11"), ">")] if not right else [])
        if left:
            trace(left_rays, 0, "<", ("00", "01"), 1, guards_y)
        if right:
            trace(right_rays, 0, ">", ("10", "11"), 1, guards_y)
        if top:
            trace(top_rays, 1, "<", ("00", "10"), 0, guards_x)
        if bottom:
            trace(bottom_rays, 1, ">", ("01", "11"), 0, guards_x)

        # View size and principal point (cc:293-311).
        mg = self.margin
        center_u = -min(p["00"][0], p["01"][0]) * focal + (0 if left else mg)
        center_v = -min(p["00"][1], p["10"][1]) * focal + (0 if top else mg)
        pixels_u = int(center_u + max(p["10"][0], p["11"][0]) * focal) + (0 if right else mg)
        pixels_v = int(center_v + max(p["01"][1], p["11"][1]) * focal) + (0 if bottom else mg)
        return ViewGeometry(
            r_ci_c=r_ci_c, center_u=center_u, center_v=center_v,
            pixels_u=max(pixels_u, 2), pixels_v=max(pixels_v, 2),
            lo_u=0.0 if left else float(mg),
            hi_u=float(pixels_u if right else pixels_u - mg),
            lo_v=0.0 if top else float(mg),
            hi_v=float(pixels_v if bottom else pixels_v - mg),
        )

    # ---- the run-time path ----

    def warp_views(self, img: torch.Tensor) -> torch.Tensor:
        """Every undistorted view, (V, maxPV, maxPU) uint8. The map
        coordinates are first quantised to 1/32 px, as the reference's
        fixed-point remap maps (cv::convertMaps CV_16SC2, 5 fractional bits;
        camera-aware-feature.cc:346-348)."""
        q = torch.round(self.dist_maps * 32.0) / 32.0
        return bilinear_remap(img.to(self.device), q[..., 0], q[..., 1])

    def detect_and_compute(self, img: torch.Tensor, mark=None):
        """Detect on one distorted (H, W) uint8 image, describe in the views,
        map the angles back. Returns (keypoints in the image's coordinates,
        descriptors (K, W) int32 words). ``mark(stage)`` is called after
        each stage: detect, warp, describe, angles."""
        mark = mark or (lambda stage: None)
        img = img.to(self.device)
        feature, cam = self.feature, self.camera
        kps = feature.detect(img)
        mark("detect")

        # removeBorderKeypoints(2.0) (cc:514, :800-813).
        s2 = 2.0 * kps.size
        ok_border = ((kps.x - s2 >= 0.0) & (kps.y - s2 >= 0.0)
                     & (kps.x + s2 <= float(cam.width)) & (kps.y + s2 <= float(cam.height)))
        # The view from the selection map at rint(x), rint(y) (cc:567-575).
        xi = torch.clamp(torch.round(kps.x).to(torch.int64), 0, cam.width - 1)
        yi = torch.clamp(torch.round(kps.y).to(torch.int64), 0, cam.height - 1)
        sel = self.sel_map[yi, xi]
        vidx = torch.clamp(sel - 1, min=0)
        # The keypoints in their views (cc:599 undistortKeypoints).
        uv = _bilerp_maps(self.undist_maps, vidx, kps.x, kps.y)
        ux, uy = uv[..., 0], uv[..., 1]
        valid = kps.valid & ok_border & (sel > 0)
        angle0 = (self._extraction_angles(kps, vidx, ux, uy)
                  if self.extraction_direction is not None else kps.angle)
        view_kps = dataclasses.replace(kps, x=ux, y=uy, angle=angle0, valid=valid)
        warped = self.warp_views(img)
        mark("warp")
        ext = feature.extractor
        out_kp, desc = extract_descriptors_views(
            ext.pattern, warped, view_kps, vidx,
            rotation_invariant=ext.rotation_invariant, scale_invariant=ext.scale_invariant,
            view_cols=self.view_cols, view_rows=self.view_rows,
        )
        mark("describe")

        # The angle back (cc:660-672): walk the size along the view angle,
        # distort both points, take the atan2 in the real image.
        angle_real = walk_angles(self.dist_maps, vidx, ux, uy, kps.size, kps.x, kps.y,
                                 angle=out_kp.angle)
        mark("angles")
        return dataclasses.replace(kps, angle=angle_real, valid=out_kp.valid), desc

    def _extraction_angles(self, kps, vidx, ux, uy):
        """The fixed extraction direction e_C as each keypoint's view angle
        (cc:607-632): through the real camera's point Jacobian at the
        keypoint, a walk of its size along it, undistorted into the view,
        the atan2 there. Where the projected direction is shorter than 0.1
        the angle stays as it was (-1: BRISK orients it)."""
        e_c = torch.tensor(self.extraction_direction, dtype=f32, device=kps.x.device)
        rays = self.camera.unproject(torch.stack([kps.x, kps.y], -1))
        jac = self.camera.project_jacobian(rays)  # (K, 2, 3)
        e_img = torch.einsum("kij,j->ki", jac, e_c)
        length = torch.linalg.vector_norm(e_img, dim=-1)
        ok = length >= 0.1
        e_img = e_img / torch.clamp(length, min=0.1)[..., None]
        ang = walk_angles(self.undist_maps, vidx, kps.x, kps.y, kps.size, ux, uy,
                          direction=(e_img[..., 0], e_img[..., 1]))
        return torch.where(ok, ang, kps.angle)
