"""Port parity: ``ba/se3.py``, ``ba/window.py`` and ``ba/pose_graph.py``
against the JAX package.

The problems are those of ``tests/test_ba.py``, built by its own helpers
and carried across with ``BaProblem.from_numpy`` / ``PoseGraph.from_numpy``,
so both packages start from the same state.

Tolerances. se3: float32 within 2e-6 absolute (the entries are O(1)),
float64 within 1e-12. Residuals, Jacobians and ``robust_cost`` in float32
within 1e-5 relative to the largest entry (torch's and XLA's einsum
orders differ). The solvers run in float64 (``jax.enable_x64(True)``):
in float32 the Schur solve of these windows amplifies sum-order
differences (one GN step moves t by 3e-4 and a fixed-pose trimmed window
was seen to settle in another minimum), while in float64 poses and points
agree to 1e-6 and costs to 1e-7 relative. LM's lambdas are held equal
while its accepted cost still moves by more than 1e-9 of the start; past
that, accept/reject compares costs at rounding level in either package.
In float32 the one GN step on the well-conditioned dense window is held
to its cost (1e-6 relative) and to 1e-4 / 1e-3 / 1e-2 on R / t / points
(on the planar window R already moves by 4e-4). The pose graph: float32 within 1e-5
on H and b, 5e-5 on the solved poses.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.ba import pose_graph as jpg  # noqa: E402
from ethzasl_brisk_tpu.ba import se3 as jse3  # noqa: E402
from ethzasl_brisk_tpu.ba import window as jw  # noqa: E402
from ethzasl_brisk_tpu_torch.ba import pose_graph as tpg  # noqa: E402
from ethzasl_brisk_tpu_torch.ba import se3 as tse3  # noqa: E402
from ethzasl_brisk_tpu_torch.ba import window as tw  # noqa: E402

from . import test_ba as jax_ba_tests  # noqa: E402


def _arrays(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _as64(arrays: dict) -> dict:
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in arrays.items()}


def _close(got, ref, rel):
    ref = np.asarray(ref)
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(float(np.abs(ref).max()), 1e-30))


# ---------------------------------------------------------------- se3

def _twists(dtype):
    rng = np.random.default_rng(0)
    xi = rng.uniform(-1, 1, (64, 6))
    # Rows 0-7 take the small-angle branch (theta^2 < 1e-8), 8-11 sit
    # just above it.
    xi[:8, :3] *= 1e-6
    xi[8:12, :3] *= 2e-4
    return xi.astype(dtype)


@pytest.mark.parametrize("x64", [False, True])
def test_se3_functions(x64):
    dtype, tol = (np.float64, 1e-12) if x64 else (np.float32, 2e-6)
    xi = _twists(dtype)
    with jax.enable_x64(x64):
        jxi = jnp.asarray(xi)
        txi = torch.from_numpy(xi)
        pairs = [
            (jse3.hat(jxi[:, :3]), tse3.hat(txi[:, :3])),
            (jse3.so3_exp(jxi[:, :3]), tse3.so3_exp(txi[:, :3])),
            (jse3._so3_left_jacobian(jxi[:, :3]), tse3._so3_left_jacobian(txi[:, :3])),
        ]
        jr, jt = jse3.se3_exp(jxi)
        tr, tt = tse3.se3_exp(txi)
        pairs += [(jr, tr), (jt, tt)]
        # Logs of the JAX rotations, so both read the same input.
        r_in = np.array(jr)
        t_in = np.array(jt)
        pairs += [(jse3.so3_log(jnp.asarray(r_in)), tse3.so3_log(torch.from_numpy(r_in))),
                  (jse3.se3_log(jnp.asarray(r_in), jnp.asarray(t_in)),
                   tse3.se3_log(torch.from_numpy(r_in), torch.from_numpy(t_in)))]
        j_c = jse3.se3_compose(jnp.asarray(r_in[:32]), jnp.asarray(t_in[:32]),
                               jnp.asarray(r_in[32:]), jnp.asarray(t_in[32:]))
        t_c = tse3.se3_compose(torch.from_numpy(r_in[:32]), torch.from_numpy(t_in[:32]),
                               torch.from_numpy(r_in[32:]), torch.from_numpy(t_in[32:]))
        j_i = jse3.se3_inverse(jnp.asarray(r_in), jnp.asarray(t_in))
        t_i = tse3.se3_inverse(torch.from_numpy(r_in), torch.from_numpy(t_in))
        pairs += list(zip(j_c, t_c)) + list(zip(j_i, t_i))
    for ref, got in pairs:
        assert got.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=tol)


def test_se3_log_of_singular_jacobian_is_nan():
    """se3_log solves with the left Jacobian; a singular one gives NaN, as
    the JAX solve gives a non-finite answer, instead of raising."""
    a = torch.zeros(2, 3, 3)
    a[0] = torch.eye(3)
    x = tse3.solve(a, torch.ones(2, 3, 1))
    assert torch.equal(x[0], torch.ones(3, 1))
    assert bool(torch.isnan(x[1]).all())


# ---------------------------------------------------------------- window BA

def _dense_problem(seed=3, noise_pose=0.02, noise_pt=0.10):
    rng = np.random.default_rng(seed)
    return jax_ba_tests.TestWindowBa()._make_problem(noise_pose, noise_pt, rng)[0]


def _planar_problem():
    """tests/test_ba.py:test_lm_cannot_diverge_on_degenerate_geometry's
    window: one plane, near-zero baseline, 0.3 px noise."""
    rng = np.random.default_rng(7)
    k, n_lm = 6, 120
    fu = fv = 400.0
    cu, cv = 320.0, 240.0
    pts_gt = np.concatenate([rng.uniform(-3, 3, (n_lm, 2)), np.full((n_lm, 1), 6.0)], 1)
    t_cam = np.zeros((k, 3))
    t_cam[:, 0] = -np.linspace(0, 1e-4, k)
    kf = np.repeat(np.arange(k), n_lm)
    lm = np.tile(np.arange(n_lm), k)
    x_c = pts_gt[lm] + t_cam[kf]
    uv = np.stack([fu * x_c[:, 0] / x_c[:, 2] + cu, fv * x_c[:, 1] / x_c[:, 2] + cv], 1)
    uv = uv + rng.normal(0, 0.3, (len(kf), 2))
    return dict(
        r=np.broadcast_to(np.eye(3), (k, 3, 3)).astype(np.float32),
        t=(t_cam + rng.normal(0, 0.02, (k, 3))).astype(np.float32),
        points=(pts_gt + rng.normal(0, 0.2, (n_lm, 3))).astype(np.float32),
        kf_idx=kf.astype(np.int32), lm_idx=lm.astype(np.int32), uv=uv.astype(np.float32),
        valid=np.ones((len(kf),), bool),
        fu=np.float32(fu), fv=np.float32(fv), cu=np.float32(cu), cv=np.float32(cv),
    )


def _moving_problem():
    """tests/test_ba.py:test_trimmed_rejects_coherent_outliers's window:
    24 of 200 landmarks on a moving object, poses 0 and 1 at ground truth."""
    rng = np.random.default_rng(9)
    prob, (r_gt, t_gt, _) = jax_ba_tests.TestWindowBa()._make_problem(0.01, 0.05, rng)
    a = _arrays(prob)
    a["r"] = a["r"].copy()
    a["t"] = a["t"].copy()
    a["r"][1] = r_gt[1]
    a["t"][1] = t_gt[1]
    bad_lm = rng.choice(200, 24, replace=False)
    bad = np.isin(a["lm_idx"], bad_lm)
    kf = a["kf_idx"][bad]
    a["uv"] = a["uv"].copy()
    a["uv"][bad] += np.stack([8.0 * kf, 3.0 * kf], 1)
    return a


def _singular_problem():
    """The dense window with every observation of pose 3 invalid: at
    damping 0 its Schur rows are zero, so LM's first solve is singular."""
    a = _arrays(_dense_problem(seed=4))
    a["valid"] = a["kf_idx"] != 3
    return a


PROBLEMS = {
    "dense": lambda: _arrays(_dense_problem()),
    "planar": _planar_problem,
    "moving": _moving_problem,
}


def _jax_problem(arrays):
    return jw.BaProblem(**{k: jnp.asarray(v) for k, v in arrays.items()})


@pytest.mark.parametrize("name", sorted(PROBLEMS))
@pytest.mark.parametrize("x64", [False, True])
def test_residuals_jacobians_and_robust_cost(name, x64):
    arrays = PROBLEMS[name]()
    if x64:
        arrays = _as64(arrays)
    rel = 1e-12 if x64 else 1e-5
    with jax.enable_x64(x64):
        jp = _jax_problem(arrays)
        tp = tw.BaProblem.from_numpy(arrays, "cpu")
        for ref, got in zip(jw._residual_and_jacobians(jp), tw._residual_and_jacobians(tp)):
            _close(got, ref, rel)
        for delta in (0.0, 3.0):
            _close(tw.robust_cost(tp, delta), jw.robust_cost(jp, delta), 10 * rel)


@pytest.mark.parametrize("name, x64", [("dense", False)] + [(n, True) for n in sorted(PROBLEMS)])
def test_gauss_newton_step(name, x64):
    arrays = PROBLEMS[name]()
    if x64:
        arrays = _as64(arrays)
    with jax.enable_x64(x64):
        jp = _jax_problem(arrays)
        tp = tw.BaProblem.from_numpy(arrays, "cpu")
        dt = jnp.float64 if x64 else jnp.float32
        jnew, jcost = jw._gauss_newton_step(jp, jnp.asarray(1e-3, dt), 2, 3.0)
        tnew, tcost = tw._gauss_newton_step(tp, 1e-3, 2, 3.0)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-9 if x64 else 1e-6)
    tols = dict(r=1e-9, t=1e-8, points=1e-7) if x64 else dict(r=1e-4, t=1e-3, points=1e-2)
    for f, tol in tols.items():
        np.testing.assert_allclose(getattr(tnew, f).numpy(), np.asarray(getattr(jnew, f)),
                                   rtol=0, atol=tol)


def _check_lambdas(t_lams, j_lams, j_costs, cost0):
    moving = np.abs(j_costs - j_costs[-1]) > 1e-9 * cost0
    n = int(np.argmin(moving)) if not moving.all() else len(moving)
    assert n >= 2, "the window converged before LM's lambda sequence says anything"
    np.testing.assert_allclose(t_lams[:n], j_lams[:n], rtol=1e-9)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_solvers_x64(name):
    arrays = _as64(PROBLEMS[name]())
    with jax.enable_x64(True):
        jp = _jax_problem(arrays)
        tp = tw.BaProblem.from_numpy(arrays, "cpu")
        cost0 = float(jw.robust_cost(jp, 3.0))

        j_gn, j_gn_costs = jw.solve_window_ba(jp, iterations=8, damping=1e-2, fix_poses=2,
                                              huber_delta=3.0)
        t_gn, t_gn_costs = tw.solve_window_ba(tp, iterations=8, damping=1e-2, fix_poses=2,
                                              huber_delta=3.0)
        j_lm, j_costs, j_lams = jw.solve_window_ba_lm(jp, iterations=12, damping=1e-2,
                                                      fix_poses=2, huber_delta=3.0)
        t_lm, t_costs, t_lams = tw.solve_window_ba_lm(tp, iterations=12, damping=1e-2,
                                                      fix_poses=2, huber_delta=3.0)
        j_tr, j_tr_costs, j_ntrim = jw.solve_window_ba_trimmed(jp, iterations=12, damping=1e-3,
                                                               fix_poses=2, huber_delta=3.0)
        t_tr, t_tr_costs, t_ntrim = tw.solve_window_ba_trimmed(tp, iterations=12, damping=1e-3,
                                                               fix_poses=2, huber_delta=3.0)
    for got, ref in ((t_gn_costs, j_gn_costs), (t_costs, j_costs), (t_tr_costs, j_tr_costs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-7, atol=1e-12 * cost0)
    _check_lambdas(t_lams.numpy(), np.asarray(j_lams), np.asarray(j_costs), cost0)
    assert int(t_ntrim) == int(j_ntrim)
    for got, ref in ((t_gn, j_gn), (t_lm, j_lm), (t_tr, j_tr)):
        for f in ("r", "t", "points"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                       rtol=0, atol=1e-6)
    if name == "moving":
        assert int(t_ntrim) >= 20


def test_lm_rejects_a_singular_window():
    """LM at damping 0 on a window whose pose 3 has no observation: the
    first Schur solve is singular. JAX's solve gives a non-finite step,
    the port's ``solve_ex`` NaN; both reject it (cost kept, lambda up to
    its 1e-10 floor) and go on to the same solution."""
    arrays = _as64(_singular_problem())
    with jax.enable_x64(True):
        jp = _jax_problem(arrays)
        tp = tw.BaProblem.from_numpy(arrays, "cpu")
        cost0 = float(jw.robust_cost(jp))
        # fix_poses=2 anchors the scale gauge too, so the solution is unique.
        j_lm, j_costs, j_lams = jw.solve_window_ba_lm(jp, iterations=8, damping=0.0, fix_poses=2)
        t_lm, t_costs, t_lams = tw.solve_window_ba_lm(tp, iterations=8, damping=0.0, fix_poses=2)
    for costs, lams, start in ((np.asarray(j_costs), np.asarray(j_lams), cost0),
                               (t_costs.numpy(), t_lams.numpy(), float(tw.robust_cost(tp)))):
        # (JAX's jitted loop and its eager robust_cost round apart.)
        assert costs[0] == pytest.approx(start, rel=1e-12) and lams[0] == 1e-10
        assert costs[-1] < 0.05 * start
    # The next step runs at lambda 1e-10, a condition number near 1e16:
    # its cost agrees to 1e-3 relative only, the solutions to 1e-6.
    np.testing.assert_allclose(t_costs.numpy(), np.asarray(j_costs), rtol=1e-3,
                               atol=1e-12 * cost0)
    np.testing.assert_allclose(t_costs.numpy()[-1], np.asarray(j_costs)[-1], rtol=1e-6)
    np.testing.assert_allclose(t_lm.t.numpy(), np.asarray(j_lm.t), rtol=0, atol=1e-6)


def test_lm_float32():
    """The dense window in float32, fix_poses 1: both converge to the same
    poses within 5e-3 (the float32 Schur solve's own spread) and their
    accepted costs stay monotone."""
    arrays = _arrays(_dense_problem())
    j_lm, j_costs, _ = jw.solve_window_ba_lm(_jax_problem(arrays), iterations=14, damping=1e-3)
    t_lm, t_costs, _ = tw.solve_window_ba_lm(tw.BaProblem.from_numpy(arrays, "cpu"),
                                             iterations=14, damping=1e-3)
    assert t_costs.dtype == torch.float32
    assert bool((t_costs[1:] <= t_costs[:-1]).all())
    assert float(t_costs[-1]) < 1e-4 * float(np.asarray(j_costs)[0])
    np.testing.assert_allclose(t_lm.t.numpy(), np.asarray(j_lm.t), rtol=0, atol=5e-3)
    np.testing.assert_allclose(t_lm.r.numpy(), np.asarray(j_lm.r), rtol=0, atol=5e-4)


def test_from_numpy_carries_every_field():
    arrays = _arrays(_dense_problem())
    tp = tw.BaProblem.from_numpy(arrays, "cpu")
    assert tp.kf_idx.dtype == tp.lm_idx.dtype == torch.int64
    for k, v in arrays.items():
        np.testing.assert_array_equal(getattr(tp, k).numpy(), v)


# ---------------------------------------------------------------- pose graph

def _loop_graph(x64=False):
    """tests/test_ba.py:TestPoseGraph's 12-node loop with its closure, plus
    a second copy of edge (3, 4): nodes 3 and 4 then sit on three edges
    each, so their diagonal blocks receive repeated scatter-adds."""
    n = 12
    rng = np.random.default_rng(7)
    angles = np.linspace(0, 2 * np.pi, n, endpoint=False)
    r_gt = np.stack([np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
                     for a in angles])
    c_gt = np.stack([5 * np.cos(angles), 5 * np.sin(angles), np.zeros(n)], 1)
    t_gt = -np.einsum("nij,nj->ni", r_gt, c_gt)
    ei = np.append(np.arange(n - 1), [n - 1, 3])
    ej = np.append(np.arange(1, n), [0, 4])
    rel_r = np.einsum("nij,nkj->nik", r_gt[ei], r_gt[ej])
    rel_t = t_gt[ei] - np.einsum("nij,nj->ni", rel_r, t_gt[ej])
    w_noise = rng.normal(0, 0.03, (n, 3))
    w_noise[0] = 0
    r0 = np.asarray(jse3.so3_exp(jnp.asarray(w_noise, jnp.float32))) @ r_gt
    t0 = t_gt + rng.normal(0, 0.2, (n, 3))
    t0[0] = t_gt[0]
    fdt = np.float64 if x64 else np.float32
    weight = np.ones(len(ei))
    weight[-1] = 0.5
    return dict(r=r0.astype(fdt), t=t0.astype(fdt), edge_i=ei.astype(np.int32),
                edge_j=ej.astype(np.int32), rel_r=rel_r.astype(fdt), rel_t=rel_t.astype(fdt),
                weight=weight.astype(fdt)), t_gt


@pytest.mark.parametrize("x64", [False, True])
def test_pose_graph(x64):
    arrays, t_gt = _loop_graph(x64)
    with jax.enable_x64(x64):
        jg = jpg.PoseGraph(**{k: jnp.asarray(v) for k, v in arrays.items()})
        tg = tpg.PoseGraph.from_numpy(arrays, "cpu")
        jh, jb, jc = jpg.assemble_normal_equations(jg, 12)
        th, tb, tc = tpg.assemble_normal_equations(tg, 12)
        assert tuple(th.shape) == (12, 6, 12, 6)
        rel = 1e-12 if x64 else 1e-5
        _close(th, jh, rel)
        _close(tb, jb, rel)
        np.testing.assert_allclose(float(tc), float(jc), rtol=10 * rel)
        j_out, j_costs = jpg.optimize_pose_graph(jg, iterations=15, damping=1e-5)
        t_out, t_costs = tpg.optimize_pose_graph(tg, iterations=15, damping=1e-5)
    tol = 1e-9 if x64 else 5e-5
    np.testing.assert_allclose(t_out.t.numpy(), np.asarray(j_out.t), rtol=0, atol=tol)
    np.testing.assert_allclose(t_out.r.numpy(), np.asarray(j_out.r), rtol=0, atol=tol)
    c0 = float(np.asarray(j_costs)[0])
    np.testing.assert_allclose(t_costs.numpy(), np.asarray(j_costs), rtol=0,
                               atol=(1e-12 if x64 else 1e-6) * c0)
    assert float(t_costs[-1]) < 1e-6
    np.testing.assert_allclose(t_out.t.numpy(), t_gt, atol=1e-2)
