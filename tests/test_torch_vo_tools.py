"""Port parity: the synthetic-sequence VO tools (``vo/synthetic.py``,
``vo/gen_sequence.py``, ``vo/sequence_eval.py``) against the JAX package's
``tools/synthetic_vo_bench.py``, ``tools/gen_synthetic_seq.py`` and
``tools/sequence_eval.py``, imported, not edited.

* The clean and ``--stress`` renders, through ``--export``, and
  ``gen_sequence``'s files: byte for byte against the JAX tools' files.
* A 3-frame ``vo.synthetic`` run on the CPU with JAX's draws replayed:
  camera centres within 5e-3, rotations within 1e-3 and the ATE within
  5e-3 of the JAX tool's ``VoFrontend.run_sequence`` (``test_torch_vo.py``'s
  bar); its printed lines, on the JAX run's poses, equal the JAX tool's.
* ``sequence_eval`` on an exported sequence, with JAX's draws: the printed
  path length and ATE within that bar of the JAX tool's lines.

The tool's camera is VGA (f = 400): a port frame on one CPU thread takes
seconds, so the runs keep three frames.
"""
import importlib.util
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.geometry import PinholeCamera as JaxCamera  # noqa: E402
from ethzasl_brisk_tpu.pipeline import BriskFeature as JaxBriskFeature  # noqa: E402
from ethzasl_brisk_tpu.vo import VoConfig as JaxVoConfig  # noqa: E402
from ethzasl_brisk_tpu.vo import VoFrontend as JaxVoFrontend  # noqa: E402
from ethzasl_brisk_tpu.vo.evaluate import ate_rmse as jax_ate_rmse  # noqa: E402
from ethzasl_brisk_tpu_torch.vo import gen_sequence, sequence, sequence_eval, synthetic  # noqa: E402

from .test_torch_vo import _key_draw  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
N = 3


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_tool(monkeypatch, name, argv):
    monkeypatch.setattr(sys, "argv", [name, *argv])
    _tool(name).main()


def _same_files(a: pathlib.Path, b: pathlib.Path) -> int:
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n
    return len(names)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("stress", [False, True], ids=["clean", "stress"])
def test_export_matches_the_jax_tool(tmp_path, monkeypatch, capsys, stress):
    flags = ["--frames", str(N), "--seed", "5"] + (["--stress"] if stress else [])
    _run_tool(monkeypatch, "synthetic_vo_bench", [*flags, "--export", str(tmp_path / "jax")])
    jax_out = capsys.readouterr().out
    assert synthetic.main([*flags, "--export", str(tmp_path / "port")]) == 0
    port_out = capsys.readouterr().out
    assert _same_files(tmp_path / "jax", tmp_path / "port") == N + 1
    assert port_out.replace(str(tmp_path / "port"), str(tmp_path / "jax")) == jax_out


def test_gen_sequence_matches_the_jax_tool(tmp_path, monkeypatch, capsys):
    _run_tool(monkeypatch, "gen_synthetic_seq", [str(tmp_path / "jax"), "--frames", str(N)])
    jax_out = capsys.readouterr().out
    assert gen_sequence.main([str(tmp_path / "port"), "--frames", str(N)]) == 0
    port_out = capsys.readouterr().out
    assert port_out.replace(str(tmp_path / "port"), str(tmp_path / "jax")) == jax_out
    assert _same_files(tmp_path / "jax", tmp_path / "port") == N + 1


@pytest.fixture(scope="module")
def runs():
    """The tool's frames, JAX's ``run_sequence`` on them (the tool's
    configuration and default key) and the port's with JAX's draws."""
    frames, poses = synthetic.render_frames(N)
    jvo = JaxVoFrontend(camera=JaxCamera.create(*synthetic.CAMERA),
                        feature=JaxBriskFeature(**synthetic.FEATURE), config=JaxVoConfig())
    jposes = jvo.run_sequence([jnp.asarray(f) for f in frames])
    tposes = synthetic.run(frames, device="cpu", draw=_key_draw(jax.random.PRNGKey(0)))
    return frames, poses, jposes, tposes


def test_synthetic_run_matches_the_jax_tool(runs, monkeypatch, capsys):
    _, poses, jposes, tposes = runs
    assert len(tposes) == len(jposes) == N
    np.testing.assert_allclose(np.stack(tposes)[:, :3, 3], np.stack(jposes)[:, :3, 3], rtol=0,
                               atol=5e-3)
    np.testing.assert_allclose(np.stack(tposes)[:, :3, :3], np.stack(jposes)[:, :3, :3], rtol=0,
                               atol=1e-3)
    stats = synthetic.evaluate(tposes, poses)
    gt = np.stack([-(r.T @ t) for r, t in poses])
    ref = jax_ate_rmse(np.stack(jposes)[:, :3, 3], gt, with_scale=True)
    assert abs(stats["ate"] - float(ref)) <= 5e-3 and stats["frames"] == N
    # The printed lines on the JAX run's poses: the tool's, character for character.
    monkeypatch.setattr(JaxVoFrontend, "run_sequence", lambda self, frames: jposes)
    _run_tool(monkeypatch, "synthetic_vo_bench", ["--frames", str(N)])
    jax_out = capsys.readouterr().out
    monkeypatch.setattr(synthetic, "run", lambda *a, **k: jposes)
    assert synthetic.main(["--frames", str(N), "--device", "cpu"]) == 0
    assert capsys.readouterr().out == jax_out
    assert '"metric": "synthetic_vo_ate_rmse_simaligned"' in jax_out


def _numbers(text: str) -> list[float]:
    return [float(v) for v in re.findall(r"-?\d+\.\d+", text)]


def test_sequence_eval_matches_the_jax_tool(runs, tmp_path, monkeypatch, capsys):
    frames, poses, _, _ = runs
    synthetic.export(frames, poses, tmp_path)
    argv = [str(tmp_path), "--gt", str(tmp_path / "poses.txt"), "--gt-format", "kitti",
            "--fu", "400", "--fv", "400", "--cu", "320", "--cv", "240"]
    _run_tool(monkeypatch, "sequence_eval", [*argv, "--platform", "cpu"])
    jax_out = capsys.readouterr().out
    run_eval = sequence.run_sequence_eval
    monkeypatch.setattr(sequence, "run_sequence_eval", lambda *a, **k: run_eval(
        *a, **k, draw=_key_draw(jax.random.PRNGKey(0))))
    assert sequence_eval.main([*argv, "--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    assert port_out.splitlines()[0].startswith(f"integrated {N} poses; path length ")
    assert port_out.splitlines()[1].startswith("ATE RMSE (sim-aligned): ")
    np.testing.assert_allclose(_numbers(port_out), _numbers(jax_out), rtol=0, atol=5e-3)
    assert len(_numbers(jax_out)) == 2
