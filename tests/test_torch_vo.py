"""Port parity: ``vo/frontend.py``, the synthetic VO scene and
``run_sequence_eval`` against the JAX package, at 240 x 320.

The frames are the synthetic two-depth scene of the JAX package's VO tests
and tools (``frames.render_scene`` on ``frames.make_texture(seed 11)``
along ``frames.trajectory``, f = 200), with the keyframed loop's detector
(``tools/kitti_eval.py``: octaves 2, no uniformity, threshold 30, 2048
candidates, 1024 keypoints) and exposure normalisation on.

Tolerances. The scene helpers, ``normalize_exposure_u8`` and
``process_frame`` are bit for bit (``process_frame`` against the JAX
front-end with ``eager_exact=True``, whose describe is jitted; the angle
too, the port taking JAX's float32 ``atan2`` and compiled chain). ``relative_pose``
takes JAX's keypoints and descriptors and JAX's draws: under float64
(``jax.enable_x64(True)`` and ``dtype=torch.float64``) R within 1e-9, t
within 1e-7 (forward-mode Jacobians of the refinement in two orders) and
the inliers equal. In float32 each package's pose is held by its distance
to that float64 answer: each LAPACK's float32 null vector of a noisy
8 x 9 system differs in the fourth digit, which moves points across the
Sampson threshold and can change the winning hypothesis, so both float32
answers sit up to 0.008 rad and 0.19 in t from the float64 one on these
pairs, while agreeing to 1e-5 with each other on four of six. The port's
float32 gaps must stay within twice JAX's, plus 1e-4 (R), 1e-3 (t) and 2
inliers.
``run_sequence`` over 4 frames with JAX's key sequence: camera centres
within 5e-3 (unit steps).
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.core.keypoints import KeyPoints as JaxKeyPoints  # noqa: E402
from ethzasl_brisk_tpu.geometry import PinholeCamera as JaxCamera  # noqa: E402
from ethzasl_brisk_tpu.geometry.ransac import _sample_indices  # noqa: E402
from ethzasl_brisk_tpu.pipeline import BriskFeature as JaxBriskFeature  # noqa: E402
from ethzasl_brisk_tpu.vo import VoConfig as JaxVoConfig  # noqa: E402
from ethzasl_brisk_tpu.vo import VoFrontend as JaxVoFrontend  # noqa: E402
from ethzasl_brisk_tpu.vo import normalize_exposure_u8 as jax_normalize  # noqa: E402
from ethzasl_brisk_tpu_torch import BriskFeature, KeyPoints  # noqa: E402
from ethzasl_brisk_tpu_torch.frames import (  # noqa: E402
    bench_frames,
    make_texture,
    render_scene,
    trajectory,
)
from ethzasl_brisk_tpu_torch.geometry import PinholeCamera  # noqa: E402
from ethzasl_brisk_tpu_torch.vo import VoConfig, VoFrontend, normalize_exposure_u8  # noqa: E402
from ethzasl_brisk_tpu_torch.vo.sequence import run_sequence_eval  # noqa: E402

from . import test_vo as jax_vo_tests  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CAM = (200.0, 200.0, 160.0, 120.0, 320, 240)
FEATURE = dict(octaves=2, uniformity_radius=0.0, absolute_threshold=30.0, max_candidates=2048,
               max_keypoints=1024)
VO = dict(normalize_exposure=True, min_inlier_spread=0.15)


@pytest.fixture(scope="module")
def frames():
    tex = make_texture(np.random.default_rng(11))
    return [render_scene(tex, PinholeCamera(*CAM), r, t) for r, t in trajectory(5)]


@pytest.fixture(scope="module")
def jax_frames(frames):
    """JAX's front-end (jitted detection, as kitti_eval runs it) on the
    frames: (keypoints, descriptors) each."""
    vo = JaxVoFrontend(camera=JaxCamera.create(*CAM), feature=JaxBriskFeature(**FEATURE),
                       config=JaxVoConfig(**VO))
    return vo, [vo.process_frame(jnp.asarray(f)) for f in frames]


def _bench_tool():
    spec = importlib.util.spec_from_file_location("synthetic_vo_bench",
                                                  ROOT / "tools" / "synthetic_vo_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_scene_helpers_match_the_jax_tools():
    tool = _bench_tool()
    a = make_texture(np.random.default_rng(3), 200, 300)
    b = tool.make_texture(np.random.default_rng(3), 200, 300)
    np.testing.assert_array_equal(a, b)
    for (ra, ta), (rb, tb) in zip(trajectory(30), tool.trajectory(30)):
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(ta, tb)
    tex = make_texture(np.random.default_rng(11))
    for r, t in trajectory(12)[::5]:
        np.testing.assert_array_equal(
            render_scene(tex, PinholeCamera(*CAM), r, t),
            jax_vo_tests.render_scene(tex, JaxCamera.create(*CAM), r, t))


def test_normalize_exposure(frames):
    """On the VO frames, the same frames under synthetic_vo_bench's stress
    gain and bias, and four VGA bench frames: every output pixel equal."""
    imgs = list(frames)
    for i, f in enumerate(frames):
        gain = 1.0 + 0.25 * np.sin(0.11 * 7 * i)
        bias = 12.0 * np.sin(0.07 * 7 * i + 1.0)
        imgs.append(np.clip(f.astype(np.float32) * gain + bias, 0, 255).astype(np.uint8))
    imgs += list(bench_frames(4))
    for img in imgs:
        for mean, std in ((128.0, 48.0), (100.0, 30.0)):
            got = normalize_exposure_u8(torch.from_numpy(img), mean, std)
            ref = np.asarray(jax_normalize(jnp.asarray(img), mean, std))
            assert got.dtype == torch.uint8
            np.testing.assert_array_equal(got.numpy(), ref)
    u16 = (bench_frames(1)[0].astype(np.uint16) * 257)
    np.testing.assert_array_equal(normalize_exposure_u8(torch.from_numpy(u16)).numpy(),
                                  np.asarray(jax_normalize(jnp.asarray(u16))))


def test_process_frame_bitwise(frames):
    jvo = JaxVoFrontend(camera=JaxCamera.create(*CAM),
                        feature=JaxBriskFeature(**FEATURE, eager_exact=True),
                        config=JaxVoConfig(**VO))
    tvo = VoFrontend(PinholeCamera(*CAM), BriskFeature(**FEATURE, device="cpu"), VoConfig(**VO))
    jk, jd = jvo.process_frame(jnp.asarray(frames[1]))
    tk, td = tvo.process_frame(torch.from_numpy(frames[1]))
    valid = np.asarray(jk.valid)
    assert valid.sum() > 300
    np.testing.assert_array_equal(tk.valid.numpy(), valid)
    for name in ("x", "y", "size", "response", "octave"):
        np.testing.assert_array_equal(getattr(tk, name).numpy().view(np.int32),
                                      np.asarray(getattr(jk, name)).view(np.int32), name)
    np.testing.assert_array_equal(tk.angle.numpy()[valid].view(np.int32),
                                  np.asarray(jk.angle)[valid].view(np.int32))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd).view(np.int32))


def _port_inputs(kp: JaxKeyPoints, desc):
    fields = {n: torch.from_numpy(np.array(getattr(kp, n))) for n in
              ("x", "y", "size", "angle", "response", "octave", "valid")}
    return KeyPoints(**fields), torch.from_numpy(np.array(desc).view(np.int32))


class _Recorder:
    """Wraps the JAX front-end's RANSAC to keep the samples its key draws."""

    def __init__(self, monkeypatch):
        import ethzasl_brisk_tpu.vo.frontend as jf

        self.calls = []
        orig = jf.ransac_essential

        def wrapped(key, r1, r2, valid, threshold, n_hypotheses):
            self.calls.append((np.asarray(_sample_indices(key, n_hypotheses, 8, r1.shape[0],
                                                          valid)).astype(np.int64),
                               np.asarray(valid)))
            return orig(key, r1, r2, valid, threshold=threshold, n_hypotheses=n_hypotheses)

        monkeypatch.setattr(jf, "ransac_essential", wrapped)

    def draw(self):
        it = iter(self.calls)

        def draw(n_hyp, k, weights):
            idx, valid = next(it)
            np.testing.assert_array_equal(weights.numpy(), valid)
            return torch.from_numpy(idx)
        return draw


def _relative_poses(jvo, outs, pair, monkeypatch, x64):
    """JAX's and the port's relative pose of a frame pair on JAX's
    keypoints, descriptors and draws, both in float32 or both in float64."""
    (ka, da), (kb, db) = outs[pair[0]], outs[pair[1]]
    rec = _Recorder(monkeypatch)
    with jax.enable_x64(x64):
        if x64:
            jvo = JaxVoFrontend(camera=JaxCamera.create(*CAM), feature=jvo.feature,
                                config=jvo.config)
        jout = [np.asarray(a) for a in jvo.relative_pose(jax.random.PRNGKey(sum(pair)), ka, da,
                                                         kb, db)]
    tvo = VoFrontend(PinholeCamera(*CAM), BriskFeature(**FEATURE, device="cpu"), VoConfig(**VO))
    tout = [a.numpy() for a in tvo.relative_pose(
        None, *_port_inputs(ka, da), *_port_inputs(kb, db), draw=rec.draw(),
        dtype=torch.float64 if x64 else torch.float32)]
    assert len(rec.calls) == 1
    assert bool(tout[3]) == bool(jout[3]) is True
    return jout, tout


def _gaps(a, b):
    return (np.abs(a[0] - b[0]).max(), np.abs(a[1] - b[1]).max(), int((a[4] != b[4]).sum()))


@pytest.mark.parametrize("pair", [(0, 1), (0, 2), (1, 4), (0, 4)])
def test_relative_pose_with_jax_draws(jax_frames, monkeypatch, pair):
    jvo, outs = jax_frames
    j64, t64 = _relative_poses(jvo, outs, pair, monkeypatch, True)
    assert t64[0].dtype == np.float64
    np.testing.assert_allclose(t64[0], j64[0], rtol=0, atol=1e-9)
    np.testing.assert_allclose(t64[1], j64[1], rtol=0, atol=1e-7)
    assert int(t64[2]) == int(j64[2])
    np.testing.assert_array_equal(t64[4], j64[4])
    # Float32: no closer to JAX's float32 answer than the float64 answer
    # is, so each is held by its distance to the float64 answer.
    j32, t32 = _relative_poses(jvo, outs, pair, monkeypatch, False)
    assert t32[0].dtype == np.float32
    jr, jt, jn = _gaps(j32, j64)
    tr_, tt, tn = _gaps(t32, j64)
    assert tr_ <= 2 * jr + 1e-4 and tt <= 2 * jt + 1e-3 and tn <= 2 * jn + 2, \
        ((tr_, tt, tn), (jr, jt, jn))


def _key_draw(key):
    """A draw that replays JAX's run_sequence keys: a split per pair."""
    state = [key]

    def draw(n_hyp, k, weights):
        state[0], sub = jax.random.split(state[0])
        return torch.from_numpy(np.asarray(_sample_indices(
            sub, n_hyp, k, weights.shape[0], jnp.asarray(weights.numpy()))).astype(np.int64))
    return draw


def test_run_sequence_and_sequence_eval(frames):
    """``run_sequence`` over 4 frames with ground-truth step norms and
    VoConfig's defaults, with JAX's key sequence, against JAX's; and
    ``run_sequence_eval`` (sequence_eval's run, tools/sequence_eval.py:59-78:
    its own detector, unit steps) equal to the port's ``run_sequence`` with
    that detector."""
    traj = trajectory(4)
    centres = np.stack([-(r.T @ t) for r, t in traj])
    norms = np.linalg.norm(np.diff(centres, axis=0), axis=1)
    jvo = JaxVoFrontend(camera=JaxCamera.create(*CAM), feature=JaxBriskFeature(**FEATURE),
                        config=JaxVoConfig())
    jposes = jvo.run_sequence([jnp.asarray(f) for f in frames[:4]], scale_norms=norms)
    tvo = VoFrontend(PinholeCamera(*CAM), BriskFeature(**FEATURE, device="cpu"), VoConfig())
    tposes = tvo.run_sequence(frames[:4], scale_norms=norms,
                              draw=_key_draw(jax.random.PRNGKey(0)))
    assert len(tposes) == len(jposes) == 4
    np.testing.assert_allclose(np.stack(tposes)[:, :3, 3], np.stack(jposes)[:, :3, 3], rtol=0,
                               atol=5e-3)
    np.testing.assert_allclose(np.stack(tposes)[:, :3, :3], np.stack(jposes)[:, :3, :3], rtol=0,
                               atol=1e-3)

    seq_feature = dict(octaves=2, uniformity_radius=0.0, absolute_threshold=30.0,
                       max_candidates=1024, max_keypoints=1024)
    seq_vo = VoFrontend(PinholeCamera(*CAM), BriskFeature(**seq_feature, device="cpu"),
                        VoConfig())
    unit = seq_vo.run_sequence(frames[:4], draw=_key_draw(jax.random.PRNGKey(0)))
    out = run_sequence_eval(frames[:4], PinholeCamera(*CAM), gt_positions=centres,
                            draw=_key_draw(jax.random.PRNGKey(0)), device="cpu")
    np.testing.assert_array_equal(out["poses"], np.stack(unit))
    from ethzasl_brisk_tpu_torch.vo.evaluate import ate_rmse

    pos = np.stack(unit)[:, :3, 3]
    assert out["ate_rmse"] == pytest.approx(ate_rmse(pos, centres, with_scale=True), rel=1e-12)
    assert out["path_length"] == pytest.approx(np.linalg.norm(np.diff(pos, axis=0), axis=1).sum())
    # The default draw (a generator on the device, seeded 0) runs too.
    assert len(tvo.run_sequence(frames[:2])) == 2
