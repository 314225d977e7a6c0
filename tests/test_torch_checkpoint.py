"""Port parity: ``utils/checkpoint.py`` against the JAX package's (Orbax)
and the keyframed loop's checkpoints.

Mirrors tests/test_checkpoint.py:18-123 on the port (``MapState`` round
trip, ``restore_or_init`` on a fresh directory, a BA solve resumed from a
checkpoint, the trajectory pack), then holds the loop state against the
JAX package: ``pack_vo_loop_state`` field by field equal to JAX's for the
same loop state (all fields but ``key``; the trajectory is compared at
JAX's float32 and the descriptors as JAX's uint32 words), and a
checkpoint written by JAX's Orbax manager and restored by it, unpacked by
the port, equal to JAX's own unpack. ``run_keyframed`` stopped partway
(by an exception from its ``mark``, as a crash would stop it, or by a
shorter frame list through the command) and resumed from its latest
checkpoint gives a result and a trajectory bitwise equal to an
uninterrupted run, with the generator's state and with a draw's cursor.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.core.keypoints import KeyPoints as JaxKeyPoints  # noqa: E402
from ethzasl_brisk_tpu.utils import checkpoint as jck  # noqa: E402
from ethzasl_brisk_tpu_torch.ba.window import BaProblem, solve_window_ba  # noqa: E402
from ethzasl_brisk_tpu_torch.core.keypoints import KeyPoints  # noqa: E402
from ethzasl_brisk_tpu_torch.geometry import PinholeCamera  # noqa: E402
from ethzasl_brisk_tpu_torch.geometry.ransac import sample_indices  # noqa: E402
from ethzasl_brisk_tpu_torch.utils.checkpoint import (  # noqa: E402
    CheckpointManager,
    MapState,
    pack_vo_loop_state,
    state_from_ba_problem,
    trajectory_to_state,
    unpack_vo_loop_state,
)
from ethzasl_brisk_tpu_torch.vo import __main__ as vo_cli  # noqa: E402
from ethzasl_brisk_tpu_torch.vo.sequence import run_keyframed  # noqa: E402

from .test_torch_vo_keyframed import CAM, CAM_FLAGS, _sequence  # noqa: E402

KP_FIELDS = ("x", "y", "size", "angle", "response", "octave", "valid")


def test_mapstate_roundtrip(tmp_path):
    state = MapState.empty(n_kf=4, n_lm=16, n_obs=32, device="cpu")
    state.t[1] = torch.tensor([1.0, 2.0, 3.0])
    state.kf_frame[0] = 7
    state.points[3] = torch.tensor([0.1, 0.2, 0.3])
    state.lm_idx[5] = 3
    state.uv[5] = torch.tensor([100.0, 50.0])
    state.valid[5] = True
    state = dataclasses.replace(state, frame_idx=torch.tensor(42, dtype=torch.int32))

    with CheckpointManager(tmp_path / "ckpt") as mgr:
        mgr.save(3, state)
        mgr.wait()
        assert mgr.latest_step() == 3
        template = MapState.empty(n_kf=4, n_lm=16, n_obs=32, device="cpu")
        restored, next_step = mgr.restore_or_init(template)
        plain, step = mgr.restore_latest()

    assert next_step == 4 and step == 3
    assert isinstance(restored, MapState) and isinstance(plain, dict)
    for f in dataclasses.fields(MapState):
        a, b = getattr(state, f.name), getattr(restored, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name
        assert torch.equal(plain[f.name], a), f.name
    # The JAX MapState's arrays carry across both ways.
    jstate = jck.MapState.empty(4, 16, 32)
    back = MapState.from_numpy({f: np.asarray(getattr(jstate, f))
                                for f in jstate.__dataclass_fields__}, device="cpu")
    for name, arr in back.to_numpy().items():
        np.testing.assert_array_equal(arr, np.asarray(getattr(jstate, name)), err_msg=name)
        assert arr.dtype == np.asarray(getattr(jstate, name)).dtype, name


def test_restore_or_init_fresh(tmp_path):
    template = MapState.empty(2, 4, 8, device="cpu")
    with CheckpointManager(tmp_path / "fresh") as mgr:
        state, step = mgr.restore_or_init(template)
        assert mgr.restore_latest() == (None, None)
    assert step == 0
    assert state is template


def test_restore_takes_the_templates_dtypes_and_checks_shapes(tmp_path):
    mgr = CheckpointManager(tmp_path / "t")
    mgr.save(0, {"a": torch.arange(4, dtype=torch.int64), "b": [np.ones(3, np.float32)]})
    got = mgr.restore(0, {"a": torch.zeros(4, dtype=torch.int32),
                          "b": [torch.zeros(3, dtype=torch.float64)]})
    assert got["a"].dtype == torch.int32 and torch.equal(got["a"], torch.arange(4).int())
    assert got["b"][0].dtype == torch.float64 and bool((got["b"][0] == 1).all())
    with pytest.raises(ValueError):
        mgr.restore(0, {"a": torch.zeros(5), "b": [torch.zeros(3)]})
    with pytest.raises(TypeError):
        mgr.save(1, {"bad": object()})


def test_max_to_keep_and_no_partial_files(tmp_path):
    mgr = CheckpointManager(tmp_path / "keep", max_to_keep=2)
    for step in (1, 5, 3, 9):
        mgr.save(step, {"step": torch.tensor(step)})
    assert mgr.all_steps() == [5, 9]
    assert mgr.latest_step() == 9
    assert sorted(p.name for p in (tmp_path / "keep").iterdir()) == ["step_5.pt", "step_9.pt"]
    mgr.save(9, {"step": torch.tensor(90)})  # a step saved again replaces the file
    assert int(mgr.restore_latest()[0]["step"]) == 90


def test_resume_continues_ba(tmp_path):
    """Preemption model: 2 GN iterations, checkpoint, 'crash', restore, 2
    more: the same state as 4 straight (bitwise: the port's solve is one
    deterministic op sequence on the CPU)."""
    rng = np.random.default_rng(3)
    n_kf, n_lm = 3, 12
    pts = rng.uniform([-2, -2, 4], [2, 2, 8], (n_lm, 3)).astype(np.float32)
    r = np.tile(np.eye(3, dtype=np.float32), (n_kf, 1, 1))
    t = np.stack([np.array([0.3 * k, 0, 0], np.float32) for k in range(n_kf)])
    kf_idx = np.repeat(np.arange(n_kf, dtype=np.int32), n_lm)
    lm_idx = np.tile(np.arange(n_lm, dtype=np.int32), n_kf)
    cam = pts[lm_idx] + t[kf_idx]
    uv = 500.0 * cam[:, :2] / cam[:, 2:3] + np.array([320.0, 240.0])
    uv += rng.normal(0, 0.5, uv.shape)

    def mk(points, rr=r, tt=t):
        return BaProblem.from_numpy(dict(
            r=rr, t=tt, points=points, kf_idx=kf_idx, lm_idx=lm_idx,
            uv=uv.astype(np.float32), valid=np.ones(len(kf_idx), bool),
            fu=np.float32(500.0), fv=np.float32(500.0), cu=np.float32(320.0),
            cv=np.float32(240.0)), device="cpu")

    noisy = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    ref, _ = solve_window_ba(mk(noisy), iterations=4)
    half, _ = solve_window_ba(mk(noisy), iterations=2)
    state = state_from_ba_problem(half, kf_frame=np.arange(n_kf), frame_idx=100)
    with CheckpointManager(tmp_path / "ba") as mgr:
        mgr.save(0, state)
        template = state_from_ba_problem(mk(noisy), kf_frame=np.zeros(n_kf), frame_idx=0)
        restored, _ = mgr.restore_or_init(template)
    assert restored.kf_idx.dtype == torch.int32 and int(restored.frame_idx) == 100
    resumed, _ = solve_window_ba(mk(restored.points.numpy(), restored.r.numpy(),
                                    restored.t.numpy()), iterations=2)
    for f in ("r", "t", "points"):
        assert torch.equal(getattr(resumed, f), getattr(ref, f)), f


def test_trajectory_state_pack_equals_jax():
    poses = np.tile(np.eye(4), (5, 1, 1))
    poses[2, 0, 3] = 1.5
    poses[3, :3, 3] = [0.1, -0.2, 1.0 / 3.0]
    st = trajectory_to_state(poses, frame_idx=5, capacity=8)
    js = jck.trajectory_to_state(poses, frame_idx=5, capacity=8)
    assert st.keys() == js.keys()
    assert st["poses"].shape == (8, 4, 4) and st["poses"].dtype == torch.float64
    assert torch.equal(st["poses"][:5], torch.from_numpy(poses))
    np.testing.assert_array_equal(st["poses"].numpy().astype(np.float32), np.asarray(js["poses"]))
    assert int(st["n"]) == int(js["n"]) == 5
    assert int(st["frame_idx"]) == int(js["frame_idx"]) == 5


def _loop_state(cap=16, n_kf=4):
    """One loop state in both packages' types: poses, prev and a keyframe
    list (the first keyframe without a match, as the loop makes it)."""
    rng = np.random.default_rng(7)

    def kp_arrays():
        return dict(x=rng.uniform(0, 320, cap).astype(np.float32),
                    y=rng.uniform(0, 240, cap).astype(np.float32),
                    size=rng.uniform(5, 40, cap).astype(np.float32),
                    angle=rng.uniform(-180, 180, cap).astype(np.float32),
                    response=rng.uniform(0, 1e4, cap).astype(np.float32),
                    octave=rng.integers(0, 4, cap).astype(np.int32),
                    valid=rng.random(cap) < 0.8)

    def desc():
        return rng.integers(0, 2**32, (cap, 12), dtype=np.uint32)

    poses = [np.eye(4)]
    for _ in range(6):
        step = np.eye(4)
        step[:3, 3] = rng.normal(0, 0.1, 3)
        poses.append(poses[-1] @ step)
    prev = (kp_arrays(), desc())
    kf = []
    for i in range(n_kf):
        match = None if i == 0 else (rng.integers(0, cap, cap).astype(np.int32),
                                     rng.random(cap) < 0.5)
        kf.append(dict(frame=2 * i, kp=kp_arrays(), desc=desc(), match_to_prev=match))

    def port_kp(a):
        return KeyPoints(**{f: torch.from_numpy(a[f]) for f in KP_FIELDS})

    def jax_kp(a):
        return JaxKeyPoints(**{f: jnp.asarray(a[f]) for f in KP_FIELDS})

    port = dict(poses=poses, prev=(port_kp(prev[0]), torch.from_numpy(prev[1].view(np.int32))),
                kf=[dict(e, kp=port_kp(e["kp"]), desc=torch.from_numpy(e["desc"].view(np.int32)))
                    for e in kf])
    jaxs = dict(poses=poses, prev=(jax_kp(prev[0]), jnp.asarray(prev[1])),
                kf=[dict(e, kp=jax_kp(e["kp"]), desc=jnp.asarray(e["desc"])) for e in kf])
    return port, jaxs


def _as_jax(name, got):
    """A port field in the JAX field's terms: uint32 words, float32 poses."""
    got = got.numpy()
    if name in ("kf_desc", "prev_desc"):
        return got.view(np.uint32)
    if name == "poses":
        return got.astype(np.float32)
    return got


def test_pack_vo_loop_state_equals_jax():
    port, jaxs = _loop_state()
    kw = dict(frame_idx=7, window=3, n_frames=10, n_ba_runs=2)
    gen = torch.Generator().manual_seed(5)
    st = pack_vo_loop_state(key=gen.get_state(), **port, **kw)
    js = jck.pack_vo_loop_state(key=jax.random.PRNGKey(0), **jaxs, **kw)
    assert st.keys() == js.keys()
    for name, ref in js.items():
        if name == "key":
            assert torch.equal(st["key"], gen.get_state())
            continue
        if name == "prev_kp":
            assert st[name].keys() == ref.keys()
            for f, v in ref.items():
                np.testing.assert_array_equal(st[name][f].numpy(), np.asarray(v), err_msg=f)
            continue
        got, want = _as_jax(name, st[name]), np.asarray(ref)
        assert got.shape == want.shape, name
        assert got.dtype == want.dtype or name == "poses", (name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=name)


def _assert_same_loop(got, want):
    """Two unpacked loop states equal (port tensors against JAX arrays)."""
    g_poses, g_i, _, g_prev, g_kf, g_runs = got
    w_poses, w_i, _, w_prev, w_kf, w_runs = want
    assert (g_i, g_runs, len(g_poses), len(g_kf)) == (w_i, w_runs, len(w_poses), len(w_kf))
    for a, b in zip(g_poses, w_poses):
        np.testing.assert_array_equal(a.astype(np.float32), np.asarray(b, np.float32))
    pairs = [(g_prev[0], w_prev[0], g_prev[1], w_prev[1])]
    pairs += [(g["kp"], w["kp"], g["desc"], w["desc"]) for g, w in zip(g_kf, w_kf)]
    for gk, wk, gd, wd in pairs:
        for f in KP_FIELDS:
            np.testing.assert_array_equal(getattr(gk, f).numpy(), np.asarray(getattr(wk, f)),
                                          err_msg=f)
        np.testing.assert_array_equal(gd.numpy().view(np.uint32), np.asarray(wd))
    for g, w in zip(g_kf, w_kf):
        assert g["frame"] == w["frame"]
        assert (g["match_to_prev"] is None) == (w["match_to_prev"] is None)
        if g["match_to_prev"] is not None:
            for a, b in zip(g["match_to_prev"], w["match_to_prev"]):
                np.testing.assert_array_equal(a, np.asarray(b))


def test_unpack_a_jax_orbax_checkpoint(tmp_path):
    """JAX packs and saves through Orbax, JAX restores without a template;
    the port unpacks what JAX restored, as JAX unpacks it."""
    _, jaxs = _loop_state()
    kw = dict(frame_idx=7, window=3, n_frames=10, n_ba_runs=2)
    with jck.CheckpointManager(tmp_path / "orbax") as mgr:
        mgr.save(7, jck.pack_vo_loop_state(key=jax.random.PRNGKey(3), **jaxs, **kw))
        mgr.wait()
        saved, step = mgr.restore_latest()
    assert step == 7
    got = unpack_vo_loop_state(saved, device="cpu")
    _assert_same_loop(got, jck.unpack_vo_loop_state(saved))
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(jax.random.PRNGKey(3)))


def test_port_unpack_inverts_pack(tmp_path):
    port, jaxs = _loop_state()
    kw = dict(frame_idx=7, window=3, n_frames=10, n_ba_runs=2)
    gen = torch.Generator().manual_seed(9)
    state_at_save = gen.get_state()
    mgr = CheckpointManager(tmp_path / "port")
    mgr.save(7, pack_vo_loop_state(key=gen.get_state(), **port, **kw))
    torch.rand(5, generator=gen)
    fresh = torch.Generator()
    got = unpack_vo_loop_state(mgr.restore_latest()[0], generator=fresh, device="cpu")
    assert torch.equal(fresh.get_state(), state_at_save)
    for a, b in zip(got[0], port["poses"]):
        assert a.dtype == np.float64 and np.array_equal(a, b)
    _assert_same_loop(got, jck.unpack_vo_loop_state(
        jck.pack_vo_loop_state(key=jax.random.PRNGKey(0), **jaxs, **kw)))


class _Crash(Exception):
    pass


def _crash_after(n_frames):
    seen = []

    def mark(stage):
        if stage == "detect":
            seen.append(1)
            if len(seen) > n_frames:
                raise _Crash
    return mark


class CursorDraw:
    """A RANSAC draw that replays its samples from a cursor: draw c takes
    its uniforms from a generator seeded with (seed, c)."""

    def __init__(self, seed: int):
        self.seed = seed
        self.cursor = 0

    def __call__(self, n_hyp, k, weights):
        gen = torch.Generator().manual_seed(self.seed * 100_003 + self.cursor)
        self.cursor += 1
        u = torch.rand((n_hyp, k), generator=gen, dtype=torch.float64)
        return sample_indices(u, weights)


@pytest.fixture(autouse=True)
def _one_thread():
    """The loop is thousands of small torch ops: under the suite's parallel
    workers the default intra-op threads oversubscribe the cores and slow
    it many times over, so these tests run on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    d = tmp_path_factory.mktemp("seq")
    frames, gt = _sequence(d, 12)
    return d, frames, gt


FLAGS = dict(kf_parallax=6.0)


def _source_kw(source):
    return {"draw": CursorDraw(3)} if source == "draw" else {}


@pytest.fixture(scope="module")
def uninterrupted(sequence):
    """The loop without checkpoints, per RANSAC source."""
    _, frames, gt = sequence
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {source: run_keyframed(frames, PinholeCamera(*CAM), gt, device="cpu",
                                      **_source_kw(source), **FLAGS)
                for source in ("generator", "draw")}
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("source", ["generator", "draw"])
def test_resume_is_bitwise_an_uninterrupted_run(sequence, uninterrupted, tmp_path, source):
    _, frames, gt = sequence
    cam = PinholeCamera(*CAM)
    ref = dict(uninterrupted[source])
    assert ref["keyframes"] == 6 and ref["ba_runs"] == 4
    ckpt = dict(checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    with pytest.raises(_Crash):
        run_keyframed(frames, cam, gt, device="cpu", mark=_crash_after(9), **_source_kw(source),
                      **ckpt, **FLAGS)
    saved = CheckpointManager(ckpt["checkpoint_dir"]).all_steps()
    assert saved and max(saved) <= 9, saved
    got = run_keyframed(frames, cam, gt, device="cpu", **_source_kw(source), **ckpt, **FLAGS)
    assert np.array_equal(got.pop("poses"), ref.pop("poses"))
    assert got == ref


def test_draw_without_cursor_cannot_checkpoint(sequence, tmp_path):
    _, frames, gt = sequence
    cursor = CursorDraw(3)

    def plain_draw(n_hyp, k, weights):
        return cursor(n_hyp, k, weights)

    with pytest.raises(ValueError):
        run_keyframed(frames, PinholeCamera(*CAM), gt, device="cpu", draw=plain_draw,
                      checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1, **FLAGS)


def test_cli_checkpoint_flags_resume(sequence, uninterrupted, tmp_path, capsys):
    """``--checkpoint-dir`` / ``--checkpoint-every``: a run over the first 8
    frames, then one over all 12 that resumes from its checkpoint, prints
    the uninterrupted run's result; a third run over the finished
    directory resumes at its last save and prints it again."""
    d, frames, gt = sequence
    flags = [*CAM_FLAGS, "--kf-parallax", "6", "--device", "cpu", "--json",
             "--gt", str(d / "poses.txt"), "--checkpoint-dir", str(tmp_path / "ck"),
             "--checkpoint-every", "2"]
    assert vo_cli.main([str(d), "--max-frames", "8", *flags]) == 0
    assert CheckpointManager(tmp_path / "ck").latest_step() is not None
    capsys.readouterr()
    ref = dict(uninterrupted["generator"])
    ref.pop("poses")
    for _ in range(2):
        assert vo_cli.main([str(d), "--max-frames", "12", *flags]) == 0
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert printed == ref
