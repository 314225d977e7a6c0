"""Port parity: ``vo/tracks.py`` and ``vo/evaluate.py`` against the JAX
package.

Tracks: ``chain_tracks`` equal on random pair matches. Midpoint
triangulation in float32 divides by the 2 x 2 determinant of the two rays,
which cancels for near-parallel rays and amplifies the last-bit
differences of torch's and XLA's sums: ``triangulate_two_view`` and the
landmarks of ``build_ba_problem`` hold 95 % of the points within 1e-5 of
the largest coordinate and all within 1e-3 (seen: 2.6e-4), the validity
masks equal. ``build_ba_problem`` on a window of noisy synthetic tracks
with and without the residual gate, and on ``tests/test_tracks.py``'s exact
scene with one moving landmark: every index, pixel and mask equal, the
intrinsics equal. Evaluate: the port's numpy copy gives the JAX module's
numbers exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.geometry import PinholeCamera as JaxCamera  # noqa: E402
from ethzasl_brisk_tpu.vo import evaluate as jev  # noqa: E402
from ethzasl_brisk_tpu.vo import tracks as jtr  # noqa: E402
from ethzasl_brisk_tpu_torch.geometry import PinholeCamera  # noqa: E402
from ethzasl_brisk_tpu_torch.vo import evaluate as tev  # noqa: E402
from ethzasl_brisk_tpu_torch.vo import tracks as ttr  # noqa: E402

CAM = (400.0, 400.0, 320.0, 240.0, 640, 480)


def _random_matches(rng, n_frames, k, p=0.6):
    out = []
    for _ in range(n_frames - 1):
        best = rng.integers(0, k, k)
        matched = rng.random(k) < p
        out.append((best, matched))
    return out


def test_chain_tracks():
    rng = np.random.default_rng(0)
    for n_frames, k in ((2, 10), (5, 64), (6, 300)):
        pm = _random_matches(rng, n_frames, k)
        assert ttr.chain_tracks(pm, None) == jtr.chain_tracks(pm, None)
    assert ttr.chain_tracks([], None) == jtr.chain_tracks([], None) == []


def test_triangulate_two_view():
    rng = np.random.default_rng(1)
    n = 200
    w = rng.normal(0, 0.05, (n, 3)).astype(np.float32)
    from ethzasl_brisk_tpu.ba.se3 import so3_exp

    r_a = np.array(so3_exp(jnp.asarray(w)))
    r_b = np.array(so3_exp(jnp.asarray(-w)))
    t_a = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    t_b = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    ray_a = rng.normal(0, 1, (n, 3)).astype(np.float32) + np.float32([0, 0, 3])
    ray_b = rng.normal(0, 1, (n, 3)).astype(np.float32) + np.float32([0, 0, 3])
    ray_a /= np.linalg.norm(ray_a, axis=1, keepdims=True)
    ray_b /= np.linalg.norm(ray_b, axis=1, keepdims=True)
    jp, jv = jtr.triangulate_two_view(*(jnp.asarray(a) for a in (r_a, t_a, r_b, t_b, ray_a,
                                                                  ray_b)))
    tp, tv = ttr.triangulate_two_view(*(torch.from_numpy(a) for a in (r_a, t_a, r_b, t_b,
                                                                      ray_a, ray_b)))
    jp = np.asarray(jp)
    assert tp.dtype == torch.float32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert 0 < int(tv.sum()) < n
    _points_close(tp.numpy(), jp)


def _points_close(got, ref):
    gap = np.abs(got - ref).max(-1) / max(float(np.abs(ref).max()), 1e-30)
    assert np.quantile(gap, 0.95) <= 1e-5 and gap.max() <= 1e-3, gap.max()


def _window(rng, n_frames=5, n_pts=300, noise=0.3):
    """Landmarks in front of a sideways-moving camera, seen by every frame
    with pixel noise, each frame's keypoints in a shuffled order, a tenth
    of the matches dropped and a few gross outliers."""
    pts = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                    rng.uniform(4.0, 9.0, n_pts)], 1)
    poses, keypoint_xy, orders = [], [], []
    for i in range(n_frames):
        a = 0.01 * i
        r = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        t = np.array([-0.2 * i, 0.01 * i, 0.0])
        x_c = pts @ r.T + t
        uv = np.stack([400.0 * x_c[:, 0] / x_c[:, 2] + 320.0,
                       400.0 * x_c[:, 1] / x_c[:, 2] + 240.0], 1)
        uv += rng.normal(0, noise, uv.shape)
        order = rng.permutation(n_pts)     # slot s of frame i holds point order[s]
        keypoint_xy.append(uv[order].astype(np.float32))
        orders.append(order)
        # Perturbed initial poses, as VO hands them to BA.
        poses.append((r @ np.array([[1, -2e-3 * i, 0], [2e-3 * i, 1, 0], [0, 0, 1]]),
                      t + rng.normal(0, 0.01, 3) * (i > 0)))
    pair_matches = []
    for i in range(1, n_frames):
        slot_prev = np.argsort(orders[i - 1])          # point -> slot in frame i-1
        best = slot_prev[orders[i]]
        matched = rng.random(n_pts) > 0.1
        bad = rng.random(n_pts) < 0.03
        best = np.where(bad, rng.integers(0, n_pts, n_pts), best)
        pair_matches.append((best, matched))
    return poses, keypoint_xy, pair_matches


def _exact_scene():
    """tests/test_tracks.py:test_residual_gate_drops_moving_track's scene."""
    rng = np.random.default_rng(0)
    n_frames, n_pts = 3, 12
    pts = np.stack([rng.uniform(-1, 1, n_pts), rng.uniform(-0.8, 0.8, n_pts),
                    rng.uniform(4.0, 7.0, n_pts)], 1)
    poses = [(np.eye(3), np.array([-0.3 * i, 0.0, 0.0])) for i in range(n_frames)]
    keypoint_xy = []
    for (r, t) in poses:
        x_c = pts @ r.T + t
        uv = np.stack([400.0 * x_c[:, 0] / x_c[:, 2] + 320.0,
                       400.0 * x_c[:, 1] / x_c[:, 2] + 240.0], 1)
        keypoint_xy.append(uv.astype(np.float32))
    keypoint_xy[1][0, 0] += 25.0
    ident = np.arange(n_pts)
    ones = np.ones(n_pts, bool)
    return poses, keypoint_xy, [(ident, ones), (ident, ones)]


@pytest.mark.parametrize("scene, kw", [
    ("window", dict(max_landmarks=1024, max_observations=4096)),
    ("window", dict(max_landmarks=1024, max_observations=4096, min_track_len=3,
                    max_obs_residual_px=2.0)),
    ("window", dict(max_landmarks=100, max_observations=700, min_track_len=4)),
    ("window", dict(max_landmarks=64, max_observations=256, min_track_len=9)),
    ("exact", dict(max_landmarks=64, max_observations=256, min_track_len=3)),
    ("exact", dict(max_landmarks=64, max_observations=256, min_track_len=3,
                   max_obs_residual_px=8.0)),
])
def test_build_ba_problem(scene, kw):
    poses, keypoint_xy, pair_matches = (
        _window(np.random.default_rng(2)) if scene == "window" else _exact_scene())
    jp = jtr.build_ba_problem(JaxCamera.create(*CAM), poses, keypoint_xy, pair_matches, **kw)
    tp = ttr.build_ba_problem(PinholeCamera(*CAM), poses, keypoint_xy, pair_matches,
                              device="cpu", **kw)
    for f in dataclasses.fields(jp):
        ref = np.asarray(getattr(jp, f.name))
        got = getattr(tp, f.name).numpy()
        assert got.shape == ref.shape, f.name
        if f.name == "points":
            _points_close(got, ref)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=f.name)
    n_valid = int(tp.valid.sum())
    if scene == "exact":
        gated = "max_obs_residual_px" in kw
        assert n_valid == (33 if gated else 36)
        assert (0 in tp.lm_idx[tp.valid].tolist()) is not gated
    else:
        # (Outlier matches can chain a track longer than the window.)
        assert n_valid > 0


def test_evaluate_copy():
    rng = np.random.default_rng(0)
    gt = np.cumsum(rng.normal(0, 0.1, (50, 3)), axis=0)
    ang = 0.3
    r = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    est = 0.5 * (gt @ r.T) + np.array([1.0, -2.0, 3.0]) + rng.normal(0, 0.01, gt.shape)
    for with_scale in (True, False):
        assert tev.ate_rmse(est, gt, with_scale) == jev.ate_rmse(est, gt, with_scale)
        for a, b in zip(tev.umeyama_alignment(est, gt, with_scale),
                        jev.umeyama_alignment(est, gt, with_scale)):
            np.testing.assert_array_equal(a, b)
    q = rng.normal(0, 1, (20, 4))
    np.testing.assert_array_equal(tev.quat_to_rot(q), jev.quat_to_rot(q))
    poses = np.tile(np.eye(4), (20, 1, 1))
    poses[:, :3, :3] = jev.quat_to_rot(q)
    poses[:, :3, 3] = gt[:20]
    noisy = poses.copy()
    noisy[:, :3, 3] += rng.normal(0, 0.02, (20, 3))
    for delta in (1, 3):
        assert tev.rpe(noisy, poses, delta) == jev.rpe(noisy, poses, delta)


def test_evaluate_loaders(tmp_path):
    tum = tmp_path / "gt.txt"
    tum.write_text("# comment\n1.0 0.1 0.2 0.3 0.0 0.0 0.0 1.0\n"
                   "2.0 0.4 0.5 0.6 0.0 0.0 0.7071068 0.7071068\n")
    for a, b in zip(tev.load_tum_trajectory(str(tum)), jev.load_tum_trajectory(str(tum))):
        np.testing.assert_array_equal(a, b)
    kitti = tmp_path / "poses.txt"
    kitti.write_text("1 0 0 5 0 1 0 6 0 0 1 7\n\n0 -1 0 1 1 0 0 2 0 0 1 3\n")
    np.testing.assert_array_equal(tev.load_kitti_trajectory(str(kitti)),
                                  jev.load_kitti_trajectory(str(kitti)))
