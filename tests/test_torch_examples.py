"""Port parity: the examples (``ethzasl_brisk_tpu_torch/examples``) against
the JAX package's ``examples/``.

``live_pipeline`` on five 120 x 160 PGM frames (crops of one smoothed-noise
image, 3 px apart, so consecutive frames match) in batches of 2, so the
second batch has a boundary pair: its ``batch`` lines equal the JAX
example's, and the match drawings it writes through ``draw`` equal the
JAX drawings byte for byte. ``cameras_demo`` prints the JAX demo's lines.
Both JAX examples run in this process on the CPU.
"""
import contextlib
import importlib.util
import io
import pathlib
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from ethzasl_brisk_tpu_torch.core.image_io import write_pgm  # noqa: E402
from ethzasl_brisk_tpu_torch.examples import cameras_demo, draw, live_pipeline  # noqa: E402
from ethzasl_brisk_tpu_torch.frames import bench_frames  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's steps are many small torch ops: under the suite's
    parallel workers the default intra-op threads oversubscribe the cores
    and slow them many times over, so these tests run on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_example(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(fn) -> list[str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn()
    return out.getvalue().splitlines()


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("live")
    base = bench_frames(1, 140, 200, seed=4)[0]
    for i in range(5):
        write_pgm(str(d / f"{i:03d}.pgm"), base[10:130, 3 * i: 3 * i + 160])
    return d


def test_live_pipeline_batch_lines_equal_jax(frames_dir, tmp_path, monkeypatch):
    port_lines = _run(lambda: live_pipeline.main(
        [str(frames_dir), "2", str(tmp_path / "port"), "--device", "cpu"]))
    monkeypatch.setattr(sys, "argv", ["live_pipeline.py", str(frames_dir), "2",
                                      str(tmp_path / "jax")])
    monkeypatch.syspath_prepend(str(ROOT))
    jax_lines = _run(_jax_example("live_pipeline").main)
    port_batches = [ln for ln in port_lines if ln.startswith("batch ")]
    assert port_batches == [ln for ln in jax_lines if ln.startswith("batch ")]
    assert len(port_batches) == 3 and "boundary-pair" in port_batches[-1], port_batches
    assert "matches/pair 0 " not in port_batches[1], port_batches
    assert "BRISK-TPU Timing" in port_lines
    drawn = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert drawn == sorted(p.name for p in (tmp_path / "jax").iterdir()) and len(drawn) == 2
    for name in drawn:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_cameras_demo_prints_the_jax_lines(monkeypatch):
    port_lines = _run(lambda: cameras_demo.main(["--device", "cpu"]))
    monkeypatch.syspath_prepend(str(ROOT))
    assert port_lines == _run(_jax_example("cameras_demo").main)
    assert len(port_lines) == 4


def test_draw_is_the_jax_drawing(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    jdraw = _jax_example("draw")
    rng = np.random.default_rng(2)
    frame = rng.integers(0, 256, (60, 80), dtype=np.uint8)

    class Kps:
        x = rng.uniform(0, 80, (2, 6)).astype(np.float32)
        y = rng.uniform(0, 60, (2, 6)).astype(np.float32)
        size = rng.uniform(4, 20, (2, 6)).astype(np.float32)
        valid = rng.random((2, 6)) < 0.8

    midx = rng.integers(0, 6, 6)
    mdist = rng.integers(0, 120, 6)
    np.testing.assert_array_equal(draw.draw_matches(frame, frame, Kps, 0, midx, mdist),
                                  jdraw.draw_matches(frame, frame, Kps, 0, midx, mdist))
