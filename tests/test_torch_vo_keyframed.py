"""Port parity: ``vo/sequence.run_keyframed`` against ``tools/kitti_eval.py``
and the ``python -m ethzasl_brisk_tpu_torch.vo`` command.

kitti_eval's ``main()`` runs in this process on 12 synthetic frames
(240 x 320, f = 200, ``frames.render_scene`` along ``frames.trajectory``)
written as PGM with their KITTI ground truth, with ``--json``, its
defaults (the trimmed solver, both gates on) and ``--kf-parallax 6`` so
that the 12 frames make six keyframes and four BA windows. Its RANSAC is
wrapped to keep the samples its key sequence draws (``PRNGKey(0)``, a
split a pair, one unused a keyframe check, one a verification), and the
port's loop is handed them in the same order; each draw also checks that
the port matched the same points. The trajectory is read from its
``rpe`` call.

Tolerances. ``frames``, ``keyframes``, ``ba_runs`` and ``ba_rejects``
equal. Poses: the float32 RANSAC of each package flips a few points at
the Sampson threshold on some pairs (see ``test_torch_vo.py``), and the
windows carry the difference on; measured, the camera centres agree to
0.05 on a 0.6 path whose ATE is 0.033 in both. Held: centres within 0.1,
rotations within 0.02, ATE within 0.01 and the path lengths within 5 %.
"""
import contextlib
import io
import json
import pathlib
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from ethzasl_brisk_tpu.core.image_io import write_pgm  # noqa: E402
from ethzasl_brisk_tpu_torch.frames import make_texture, render_scene, trajectory  # noqa: E402
from ethzasl_brisk_tpu_torch.geometry import PinholeCamera  # noqa: E402
from ethzasl_brisk_tpu_torch.vo import __main__ as vo_cli  # noqa: E402
from ethzasl_brisk_tpu_torch.vo.evaluate import load_kitti_trajectory  # noqa: E402
from ethzasl_brisk_tpu_torch.vo.sequence import KEYFRAMED_DEFAULTS, run_keyframed  # noqa: E402

from .test_torch_vo import _Recorder  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CAM = (200.0, 200.0, 160.0, 120.0, 320, 240)
CAM_FLAGS = ["--fu", "200", "--fv", "200", "--cu", "160", "--cv", "120"]


def _sequence(tmp_path, n):
    cam = PinholeCamera(*CAM)
    tex = make_texture(np.random.default_rng(11))
    traj = trajectory(n)
    frames = [render_scene(tex, cam, r, t) for r, t in traj]
    lines = []
    for i, (f, (r, t)) in enumerate(zip(frames, traj)):
        write_pgm(str(tmp_path / f"{i:06d}.pgm"), f)
        m = np.hstack([r.T, (-r.T @ t)[:, None]])
        lines.append(" ".join(f"{v:.9f}" for v in m.reshape(-1)))
    (tmp_path / "poses.txt").write_text("\n".join(lines) + "\n")
    return frames, load_kitti_trajectory(str(tmp_path / "poses.txt"))


def _kitti_eval(monkeypatch, args):
    """tools/kitti_eval.py's main() on ``args``: its JSON result, its
    trajectory and a recorder of its RANSAC draws, in order."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import kitti_eval
    finally:
        sys.path.remove(str(ROOT / "tools"))
    import ethzasl_brisk_tpu.vo.evaluate as jev

    rec = _Recorder(monkeypatch)
    seen = {}
    orig_rpe = jev.rpe

    def rpe(est, gt, delta=1):
        seen["poses"] = np.array(est)
        return orig_rpe(est, gt, delta)

    monkeypatch.setattr(jev, "rpe", rpe)
    monkeypatch.setattr(sys, "argv", ["kitti_eval.py", *args])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        kitti_eval.main()
    return json.loads(out.getvalue().strip().splitlines()[-1]), seen["poses"], rec


def test_run_keyframed_matches_kitti_eval(tmp_path, monkeypatch):
    frames, gt = _sequence(tmp_path, 12)
    flags = [*CAM_FLAGS, "--kf-parallax", "6"]
    jres, jposes, rec = _kitti_eval(
        monkeypatch, [str(tmp_path), "--gt", str(tmp_path / "poses.txt"), "--json", *flags])
    args = vo_cli.parse_args([str(tmp_path), *flags])
    tres = run_keyframed(frames, PinholeCamera(*CAM), gt, draw=rec.draw(), device="cpu",
                         **{k: getattr(args, k) for k in KEYFRAMED_DEFAULTS})
    assert tres["capacity_ok"] is True
    for key in ("frames", "keyframes", "ba_runs", "ba_rejects"):
        assert tres[key] == jres[key], key
    assert jres["keyframes"] == 6 and jres["ba_runs"] == 4
    tposes = tres["poses"]
    assert tposes.shape == jposes.shape == (12, 4, 4)
    np.testing.assert_allclose(tposes[:, :3, 3], jposes[:, :3, 3], rtol=0, atol=0.1)
    np.testing.assert_allclose(tposes[:, :3, :3], jposes[:, :3, :3], rtol=0, atol=0.02)
    assert abs(tres["ate_rmse"] - jres["ate_rmse"]) < 0.01
    assert tres["path_length"] == pytest.approx(jres["path_length"], rel=0.05)
    assert tres["rpe_rot_rmse_deg"] == pytest.approx(jres["rpe_rot_rmse_deg"], rel=0.2)


def test_cli_prints_run_keyframed(tmp_path, capsys):
    """The command's JSON line is ``run_keyframed``'s result (its poses
    left out) for the same flags, with the default draw."""
    frames, gt = _sequence(tmp_path, 5)
    flags = [*CAM_FLAGS, "--kf-parallax", "4", "--ba-solver", "lm", "--max-frames", "5"]
    assert vo_cli.main([str(tmp_path), "--gt", str(tmp_path / "poses.txt"), "--device", "cpu",
                        "--json", *flags]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    args = vo_cli.parse_args([str(tmp_path), *flags])
    res = run_keyframed(frames, PinholeCamera(*CAM), gt, device="cpu",
                        **{k: getattr(args, k) for k in KEYFRAMED_DEFAULTS})
    res.pop("poses")
    assert printed == res
    assert res["keyframes"] >= 3 and res["ba_runs"] >= 1


def test_run_keyframed_rejects_unknown_flags():
    with pytest.raises(TypeError):
        run_keyframed([], PinholeCamera(*CAM), device="cpu", resume_from="x")
    with pytest.raises(ValueError):
        run_keyframed([np.zeros((8, 8), np.uint8)], PinholeCamera(*CAM), device="cpu",
                      ba_solver="newton")
