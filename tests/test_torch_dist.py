"""Port parity: the sharded layer (``parallel/frames.py``'s mesh, sharded knn
and data-parallel frame step, ``parallel/dist_ba.py``,
``parallel/dist_pg.py`` and the ``worker`` command) against the JAX
package.

The port runs in 2 and 4 spawned processes on the CPU, a gloo group met
through a FileStore under the test's temporary directory, each process
joined with a timeout of 120 s (``tests/_torch_dist_ranks.py``); the JAX
sharded functions run in this process over the same number of devices of
the virtual 8-device CPU mesh (``make_mesh(1, S)``).

Tolerances. The sharded knn, ``partition_problem`` and ``partition_edges``
bitwise. ``solve_window_ba_sharded`` (10 GN iterations on the dense window
of tests/test_ba.py less some observations, so that shards are padded) and
``optimize_pose_graph_sharded`` (15 iterations on its loop with a repeated
edge): in float64 (JAX under ``jax.enable_x64(True)``) r, t, points and
costs within 1e-9 of the largest reference entry; in float32 JAX's own bars
for its sharded solvers against its single-device ones
(tests/test_ba.py:310-315, :398-405): translations within 5e-3 up to the
monocular gauge scale and a reprojection RMS under 0.05 px for BA, poses
within 1e-4 for the pose graph. The data-parallel frame step over a (2, 1)
mesh: bitwise equal to the port's one-device step, with describe budgets
that cover the batch while one shard holds more than its share (42 a frame)
and that truncate the batch (30 a frame), and every rank's outputs equal;
the AST step likewise, with a budget that covers the batch while the first
shard is over its share. The same frame step against the JAX
``FramePipeline`` over a (2, 1) mesh of the virtual devices, at both
budgets: keypoints, descriptors and matches bitwise, the angle within
1e-4 degree (atan2 differs between backends by an ULP, as in
tests/test_torch_pipeline.py). Over a (4, 1) mesh the step is not bitwise on the
CPU: torch's CPU atan2 gives other last bits in the scalar tail of its
vector loop than in its lanes, so a slot's angle depends on its position in
the described batch (2 ULP apart on these frames); on the card each slot's
atan2 is its own thread's.
"""
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.ba import pose_graph as jpg  # noqa: E402
from ethzasl_brisk_tpu.ba import window as jw  # noqa: E402
from ethzasl_brisk_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from ethzasl_brisk_tpu.parallel import sharded_knn_match as jax_sharded_knn  # noqa: E402
from ethzasl_brisk_tpu.parallel.dist_ba import partition_problem as jax_partition  # noqa: E402
from ethzasl_brisk_tpu.parallel.dist_ba import solve_window_ba_sharded as jax_ba  # noqa: E402
from ethzasl_brisk_tpu.parallel.dist_pg import optimize_pose_graph_sharded as jax_pg  # noqa: E402
from ethzasl_brisk_tpu.parallel.dist_pg import partition_edges as jax_edges  # noqa: E402
from ethzasl_brisk_tpu.parallel.frames import FramePipeline as JaxFramePipeline  # noqa: E402
from ethzasl_brisk_tpu.pipeline import BriskFeature as JaxBriskFeature  # noqa: E402
from ethzasl_brisk_tpu_torch import (  # noqa: E402
    AstFramePipeline,
    BriskFeature,
    BriskFeatureDetector,
    FramePipeline,
)
from ethzasl_brisk_tpu_torch.frames import bench_frames  # noqa: E402
from ethzasl_brisk_tpu_torch.parallel import init_process_group, make_mesh  # noqa: E402
from ethzasl_brisk_tpu_torch.parallel.multihost import spawn  # noqa: E402

from . import _torch_dist_ranks as ranks  # noqa: E402
from .test_torch_ba import _arrays, _as64, _dense_problem, _loop_graph  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
JOIN_S = 120
FRAME_CAPS = (42, 30)


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's steps are many small torch ops: under the suite's
    parallel workers the default intra-op threads oversubscribe the cores
    and slow them many times over, so these tests run on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames() -> np.ndarray:
    """Four 120 x 160 frames: two of dense noise, then two of low contrast,
    so the first rank holds ~3/4 of the batch's describable keypoints."""
    f = bench_frames(4, 120, 160, seed=9)
    f[2:] = (f[2:].astype(np.float32) * 0.25 + 96).astype(np.uint8)
    return f


def _inputs() -> dict:
    rng = np.random.default_rng(11)
    out = dict(
        knn_q=rng.integers(0, 2**32, (96, 12), dtype=np.uint32).view(np.int32),
        knn_t=rng.integers(0, 2**32, (256, 12), dtype=np.uint32).view(np.int32),
        knn_tv=rng.random(256) < 0.9,
        frames=_frames(),
    )
    ba32 = _arrays(_dense_problem(seed=5))
    # Drop the odd-quarter landmarks' later observations, so shards hold
    # unequal counts and partition_problem pads some with invalid slots.
    keep = ~((ba32["lm_idx"] % 4 == 1) & (ba32["kf_idx"] >= 3))
    ba32.update({k: ba32[k][keep] for k in ("kf_idx", "lm_idx", "uv", "valid")})
    for tag, arrays in (("f32", ba32), ("f64", _as64(ba32))):
        out.update({f"ba_{tag}_{k}": v for k, v in arrays.items()})
    for tag, x64 in (("f32", False), ("f64", True)):
        out.update({f"pg_{tag}_{k}": v for k, v in _loop_graph(x64)[0].items()})
    return out


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    """The port's ranks at world size S (the test's parameter): (S, inputs,
    every rank's outputs). The frame step runs at S = 2 only."""
    world = request.param
    work = tmp_path_factory.mktemp(f"dist{world}")
    inputs = _inputs()
    np.savez(work / "inputs.npz", **inputs)
    caps = FRAME_CAPS if world == 2 else ()
    spawn(ranks.run_rank, world, (world, str(work / "store"), str(work), caps), timeout=JOIN_S)
    return world, inputs, [dict(np.load(work / f"out_{r}.npz")) for r in range(world)]


def _sub(inputs: dict, prefix: str) -> dict:
    return {k.removeprefix(prefix): v for k, v in inputs.items() if k.startswith(prefix)}


def _close(got, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * float(np.abs(ref).max()))


WORLDS = pytest.mark.parametrize("runs", [2, 4], indirect=True, ids=["world2", "world4"])
WORLD2 = pytest.mark.parametrize("runs", [2], indirect=True, ids=["world2"])


@WORLDS
def test_ranks_agree(runs):
    _, _, outs = runs
    for other in outs[1:]:
        assert other.keys() == outs[0].keys()
        for k, v in outs[0].items():
            np.testing.assert_array_equal(other[k], v, err_msg=k)


@WORLDS
def test_sharded_knn_bitwise(runs):
    world, inputs, outs = runs
    q = jnp.asarray(inputs["knn_q"].view(np.uint32))
    t = jnp.asarray(inputs["knn_t"].view(np.uint32))
    tv = jnp.asarray(inputs["knn_tv"])
    mesh = jax_make_mesh(1, world)
    with mesh:
        idx, dist_k = jax_sharded_knn(mesh, q, t, tv, k=2)
    np.testing.assert_array_equal(outs[0]["knn_idx"], np.asarray(idx))
    np.testing.assert_array_equal(outs[0]["knn_dist"], np.asarray(dist_k))


@WORLDS
@pytest.mark.parametrize("tag", ["f32", "f64"])
def test_partitions_bitwise(runs, tag):
    world, inputs, outs = runs
    with jax.enable_x64(tag == "f64"):
        prob = jw.BaProblem(**{k: jnp.asarray(v) for k, v in _sub(inputs, f"ba_{tag}_").items()})
        part = jax_partition(prob, world)
        graph = jpg.PoseGraph(**{k: jnp.asarray(v)
                                 for k, v in _sub(inputs, f"pg_{tag}_").items()})
        padded = jax_edges(graph, world)
    for name, ref in ((f"part_{tag}_", part), (f"edges_{tag}_", padded)):
        for f in dataclasses.fields(ref):
            got, want = outs[0][name + f.name], np.asarray(getattr(ref, f.name))
            assert got.shape == want.shape, (name, f.name)
            np.testing.assert_array_equal(got, want, err_msg=name + f.name)


@WORLDS
def test_ba_sharded(runs):
    world, inputs, outs = runs
    mesh = jax_make_mesh(1, world)
    ref = {}
    for tag in ("f32", "f64"):
        with jax.enable_x64(tag == "f64"):
            prob = jw.BaProblem(**{k: jnp.asarray(v)
                                   for k, v in _sub(inputs, f"ba_{tag}_").items()})
            with mesh:
                solved, costs = jax_ba(mesh, jax_partition(prob, world),
                                       iterations=ranks.BA_ITERATIONS, damping=ranks.BA_DAMPING)
            ref[tag] = {f: np.asarray(getattr(solved, f)) for f in ("r", "t", "points")}
            ref[tag]["costs"] = np.asarray(costs)
    o = outs[0]
    for f in ("r", "t", "points", "costs"):
        assert o[f"ba_f64_{f}"].dtype == np.float64
        _close(o[f"ba_f64_{f}"], ref["f64"][f], 1e-9)
    # float32: JAX's bars for its sharded solver (tests/test_ba.py:310-315).
    ts, td = ref["f32"]["t"], o["ba_f32_t"]
    scale = np.linalg.norm(ts[1:]) / np.linalg.norm(td[1:])
    np.testing.assert_allclose(td * scale, ts, rtol=5e-3, atol=5e-3)
    from ethzasl_brisk_tpu_torch.ba.window import BaProblem, _residual_and_jacobians

    solved = BaProblem.from_numpy(dict(_sub(inputs, "ba_f32_"), **{
        "r": o["ba_f32_r"], "t": o["ba_f32_t"], "points": o["ba_f32_points"],
        **{f: o[f"part_f32_{f}"] for f in ("kf_idx", "lm_idx", "uv", "valid")}}), "cpu")
    res, _, _, w = _residual_and_jacobians(solved)
    rms = float(torch.sqrt((res ** 2).sum(1)[w > 0].mean()))
    assert rms < 0.05, rms


@WORLDS
def test_pose_graph_sharded(runs):
    world, inputs, outs = runs
    mesh = jax_make_mesh(1, world)
    o = outs[0]
    for tag in ("f32", "f64"):
        with jax.enable_x64(tag == "f64"):
            graph = jpg.PoseGraph(**{k: jnp.asarray(v)
                                     for k, v in _sub(inputs, f"pg_{tag}_").items()})
            with mesh:
                out, costs = jax_pg(mesh, jax_edges(graph, world),
                                    iterations=ranks.PG_ITERATIONS, damping=ranks.PG_DAMPING)
        if tag == "f64":
            for name, ref in (("r", out.r), ("t", out.t), ("costs", costs)):
                _close(o[f"pg_f64_{name}"], ref, 1e-9)
        else:
            for name, ref in (("r", out.r), ("t", out.t)):
                np.testing.assert_allclose(o[f"pg_f32_{name}"], np.asarray(ref), atol=1e-4)
        assert float(o[f"pg_{tag}_costs"][-1]) < 1e-6


@WORLD2
@pytest.mark.parametrize("cap", FRAME_CAPS)
def test_frame_step_over_a_data_mesh_is_bitwise(runs, cap):
    world, inputs, outs = runs
    frames = torch.from_numpy(inputs["frames"])
    feature = BriskFeature(**ranks.FEATURE, describe_capacity=cap, device="cpu")
    kps, desc, midx, mdist, diag = FramePipeline(feature, "cpu").step(frames,
                                                                      with_diagnostics=True)
    o = outs[0]
    for f in dataclasses.fields(kps):
        np.testing.assert_array_equal(o[f"step{cap}_kp_{f.name}"], getattr(kps, f.name).numpy(),
                                      err_msg=f.name)
    for name, ref in (("desc", desc), ("midx", midx), ("mdist", mdist)):
        np.testing.assert_array_equal(o[f"step{cap}_{name}"], ref.numpy(), err_msg=name)
    np.testing.assert_array_equal(o[f"step{cap}_ok"], diag["detect"].ok.numpy())
    total = int(diag["describable"])
    assert int(o[f"step{cap}_describable"]) == total
    # The case each budget stands for: the first rank's frames hold more
    # than their share of the budget; the batch fits it (42) or not (30).
    from ethzasl_brisk_tpu_torch.describe.extractor import _describable_mask

    per_rank = frames.shape[0] // world
    first = int(_describable_mask(feature.pattern, 120, 160,
                                  feature.detect(frames[:per_rank])).sum())
    budget = cap * frames.shape[0]
    assert first > cap * per_rank
    assert (total <= budget) == (cap == 42), (total, budget)
    assert int(kps.valid.sum()) == min(total, budget)


@WORLD2
@pytest.mark.parametrize("cap", FRAME_CAPS)
def test_frame_step_over_a_data_mesh_matches_jax_mesh(runs, cap):
    """The port's step over a (2, 1) gloo mesh against the JAX step over a
    (2, 1) mesh of the virtual devices, on the same frames and budget."""
    world, inputs, outs = runs
    mesh = jax_make_mesh(world, 1)
    with mesh:
        jkp, jdesc, jmidx, jmdist = JaxFramePipeline(
            JaxBriskFeature(**ranks.FEATURE, describe_capacity=cap), mesh
        ).step(jnp.asarray(inputs["frames"]))
    o = outs[0]
    valid = np.asarray(jkp.valid)
    assert valid.sum() > 100
    for f in ("x", "y", "size", "response", "octave", "valid"):
        np.testing.assert_array_equal(o[f"step{cap}_kp_{f}"], np.asarray(getattr(jkp, f)),
                                      err_msg=f)
    np.testing.assert_allclose(o[f"step{cap}_kp_angle"][valid], np.asarray(jkp.angle)[valid],
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(o[f"step{cap}_desc"], np.asarray(jdesc).view(np.int32))
    np.testing.assert_array_equal(o[f"step{cap}_midx"], np.asarray(jmidx))
    np.testing.assert_array_equal(o[f"step{cap}_mdist"], np.asarray(jmdist))


def test_worker_command(tmp_path):
    """multihost_worker's run as two processes of the port's command: the
    BA and the pose graph converge as the JAX worker's do
    (tests/test_ba.py:TestMultiHost's bars)."""
    store = tmp_path / "store"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ethzasl_brisk_tpu_torch.parallel", "worker", str(i), "2",
         str(store), "--device", "cpu"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for i in range(2)]
    try:
        logs = [p.communicate(timeout=JOIN_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], b"\n".join(logs).decode()[-2000:]
    c0, c1, pg_cost, pg_terr = (float(v) for v in (store / "result.txt").read_text().split())
    assert c0 > 100.0 and c1 < 1e-4, (c0, c1)
    assert pg_cost < 1e-6 and pg_terr < 1e-2, (pg_cost, pg_terr)


def test_mesh_needs_a_group_and_the_card_needs_nccl(tmp_path):
    with pytest.raises(RuntimeError):
        make_mesh(1, 1, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            init_process_group(0, 1, tmp_path, "cuda")


@WORLD2
def test_ast_step_over_a_data_mesh_is_bitwise(runs):
    """The AST step over the (2, 1) mesh, its budget covering the batch
    while the first rank holds more than its share."""
    world, inputs, outs = runs
    frames = torch.from_numpy(inputs["frames"])
    det = BriskFeatureDetector(**ranks.AST_DETECTOR, device="cpu")
    kps, desc, midx, mdist, diag = AstFramePipeline(
        det, "cpu", describe_capacity=ranks.AST_CAP).step(frames, with_diagnostics=True)
    o = outs[0]
    for f in dataclasses.fields(kps):
        np.testing.assert_array_equal(o[f"ast_kp_{f.name}"], getattr(kps, f.name).numpy(),
                                      err_msg=f.name)
    for name, ref in (("desc", desc), ("midx", midx), ("mdist", mdist)):
        np.testing.assert_array_equal(o[f"ast_{name}"], ref.numpy(), err_msg=name)
    assert bool(diag["detect"].ok.all()) and o["ast_ok"].all()
    total = int(diag["describable"])
    assert int(o["ast_describable"]) == total
    from ethzasl_brisk_tpu_torch.describe.extractor import describable_count

    first = int(describable_count(det.pattern, frames[:2], det.detect(frames[:2])))
    assert first > 2 * ranks.AST_CAP and total <= 4 * ranks.AST_CAP, (first, total)


@WORLD2
def test_uneven_batch_raises(runs):
    _, _, outs = runs
    assert bool(outs[0].get("uneven_batch_raises", False))
