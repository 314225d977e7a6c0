"""Port parity: ``geometry/ransac.py`` against the JAX package.

The scenes are ``tests/test_geometry.py:65-142`` (a homography with 30 %
outliers, an essential matrix with 25 %), and the port is handed JAX's own
draws (``_sample_indices`` on the same key) through ``samples``.

Tolerances. Per hypothesis, only samples whose indices are distinct are
compared: JAX draws with replacement, and a sample that repeats an index
has a 2-D null space from which each LAPACK picks its own vector. On
those, H (after its ``h[2,2]`` normalisation) within 1e-9 of its largest
entry in float64; in float32 95 % within 1e-4 and all within 1e-2 (the
minimal 4-point systems agree to 2e-6 at the median, a tail of
near-degenerate ones to 2.5e-3), E up to sign within 1e-3 / 1e-9 (8 x 9
float32 systems of noisy points are ill-conditioned: the worst of 512
seen at 3.5e-4); the error functions on JAX's own models within 1e-4
relative (float32) / 1e-9; the per-hypothesis inlier counts within 1 % of the
points in float32 (the hypotheses whose E moved flip points at the
Sampson threshold), equal in float64. The winner, the final model, the
inlier mask and the count: equal, E within 1e-5 (float32) / 1e-10, H
within 2e-3 of its largest entry in float32 (its refit is a 420 x 9
weighted DLT, seen 9e-4 apart) / 1e-10.
``decompose_essential`` and ``refine_relative_pose`` on JAX's E: (R, t)
within 1e-5 / 1e-10 and the same in-front count; the refined costs of the
noiseless scene both at rounding level (1e-12 / 1e-28).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.geometry import ransac as jr  # noqa: E402
from ethzasl_brisk_tpu_torch.geometry import ransac as tr  # noqa: E402


def homography_scene():
    rng = np.random.default_rng(3)
    h_true = np.array([[0.9, 0.1, 10.0], [-0.05, 1.05, -20.0], [1e-4, -5e-5, 1.0]])
    n = 300
    p1 = rng.uniform(0, 600, (n, 2))
    ph = np.concatenate([p1, np.ones((n, 1))], 1) @ h_true.T
    p2 = ph[:, :2] / ph[:, 2:]
    out = rng.random(n) < 0.3
    p2[out] += rng.uniform(20, 100, (out.sum(), 2))
    return p1, p2, np.ones((n,), bool)


def essential_scene():
    rng = np.random.default_rng(4)
    angle = 0.1
    r_true = np.array([[np.cos(angle), 0, np.sin(angle)], [0, 1, 0],
                       [-np.sin(angle), 0, np.cos(angle)]])
    t_true = np.array([0.5, 0.1, 0.05])
    t_true /= np.linalg.norm(t_true)
    n = 400
    pts = rng.uniform([-2, -2, 4], [2, 2, 10], (n, 3))
    p_c2 = pts @ r_true.T + t_true
    r1 = pts[:, :2] / pts[:, 2:]
    r2 = p_c2[:, :2] / p_c2[:, 2:]
    out = rng.random(n) < 0.25
    r2[out] += rng.uniform(0.05, 0.2, (out.sum(), 2))
    # A fifth of the points unmatched, so the draw's weights matter.
    valid = np.ones((n,), bool)
    valid[::5] = False
    return r1, r2, valid


def _dtypes(x64):
    return (np.float64, torch.float64) if x64 else (np.float32, torch.float32)


def _jax_samples(key, n_hyp, k, n, valid):
    return np.asarray(jr._sample_indices(key, n_hyp, k, n, jnp.asarray(valid))).astype(np.int64)


def _distinct(idx):
    return np.array([len(set(row)) == len(row) for row in idx])


@pytest.mark.parametrize("x64", [False, True])
def test_ransac_homography(x64):
    ndt, tdt = _dtypes(x64)
    p1, p2, valid = homography_scene()
    p1, p2 = p1.astype(ndt), p2.astype(ndt)
    key = jax.random.PRNGKey(0)
    with jax.enable_x64(x64):
        idx = _jax_samples(key, 256, 4, len(p1), valid)
        jh = np.array(jr.fit_homography_dlt(jnp.asarray(p1)[idx], jnp.asarray(p2)[idx]))
        j_err = np.asarray(jr.homography_reproj_error(jnp.asarray(jh), jnp.asarray(p1)[None],
                                                      jnp.asarray(p2)[None]))
        j_out = [np.asarray(a) for a in jr.ransac_homography(
            key, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid), threshold=2.0)]
    tp1, tp2 = torch.from_numpy(p1), torch.from_numpy(p2)
    th = tr.fit_homography_dlt(tp1[idx], tp2[idx]).numpy()
    t_err = tr.homography_reproj_error(torch.from_numpy(th), tp1[None], tp2[None]).numpy()
    t_out = [a.numpy() for a in tr.ransac_homography(
        None, tp1, tp2, torch.from_numpy(valid), threshold=2.0,
        samples=torch.from_numpy(idx), dtype=tdt)]
    d = _distinct(idx)
    assert d.sum() > 200
    gap = np.abs(th - jh).max((1, 2))[d] / np.abs(jh).max((1, 2))[d]
    if x64:
        assert gap.max() < 1e-9
    else:
        # Minimal 4-point systems: most agree to 1e-5, a tail of
        # near-degenerate samples to 2.5e-3.
        assert np.quantile(gap, 0.95) < 1e-4 and gap.max() < 1e-2, gap.max()
    # The error function on JAX's own models, then the scores of each
    # package's models.
    on_j = tr.homography_reproj_error(torch.from_numpy(jh), tp1[None], tp2[None]).numpy()
    np.testing.assert_allclose(on_j, j_err, rtol=1e-9 if x64 else 1e-4, atol=1e-6)
    j_sc = (j_err < 4.0).sum(1)
    t_sc = (t_err < 4.0).sum(1)
    assert np.abs(t_sc - j_sc)[d].max() <= (0 if x64 else 0.01 * len(p1))
    # Winner and result.
    assert int(t_out[2]) == int(j_out[2])
    np.testing.assert_array_equal(t_out[1], j_out[1])
    np.testing.assert_allclose(t_out[0], j_out[0], rtol=0,
                               atol=(1e-10 if x64 else 2e-3) * np.abs(j_out[0]).max())
    assert t_out[0].dtype == ndt


@pytest.mark.parametrize("x64", [False, True])
def test_ransac_essential(x64):
    ndt, tdt = _dtypes(x64)
    r1, r2, valid = essential_scene()
    r1, r2 = r1.astype(ndt), r2.astype(ndt)
    key = jax.random.PRNGKey(1)
    with jax.enable_x64(x64):
        idx = _jax_samples(key, 512, 8, len(r1), valid)
        je = np.array(jr.fit_essential_8pt(jnp.asarray(r1)[idx], jnp.asarray(r2)[idx]))
        j_err = np.asarray(jr.sampson_error(jnp.asarray(je), jnp.asarray(r1)[None],
                                            jnp.asarray(r2)[None]))
        j_out = [np.asarray(a) for a in jr.ransac_essential(
            key, jnp.asarray(r1), jnp.asarray(r2), jnp.asarray(valid), threshold=1e-5)]
    assert valid[idx].all(), "JAX draws only matched points"
    tr1, tr2 = torch.from_numpy(r1), torch.from_numpy(r2)
    te = tr.fit_essential_8pt(tr1[idx], tr2[idx]).numpy()
    t_err = tr.sampson_error(torch.from_numpy(te), tr1[None], tr2[None]).numpy()
    t_out = [a.numpy() for a in tr.ransac_essential(
        None, tr1, tr2, torch.from_numpy(valid), threshold=1e-5,
        samples=torch.from_numpy(idx), dtype=tdt)]
    d = _distinct(idx)
    assert d.sum() > 400
    on_j = tr.sampson_error(torch.from_numpy(je), tr1[None], tr2[None]).numpy()
    np.testing.assert_allclose(on_j, j_err, rtol=1e-9 if x64 else 1e-4, atol=1e-12)
    sign = np.sign((te * je).sum((1, 2)))[:, None, None]
    np.testing.assert_allclose((sign * te)[d], je[d], rtol=0, atol=1e-9 if x64 else 1e-3)
    j_sc = ((j_err < 1e-5) & valid).sum(1)
    t_sc = ((t_err < 1e-5) & valid).sum(1)
    assert np.abs(t_sc - j_sc)[d].max() <= (0 if x64 else 0.01 * len(r1))
    assert int(np.argmax(t_sc)) == int(np.argmax(j_sc))
    assert int(t_out[2]) == int(j_out[2]) > 0.85 * 0.75 * valid.sum()
    np.testing.assert_array_equal(t_out[1], j_out[1])
    sign = np.sign((t_out[0] * j_out[0]).sum())
    np.testing.assert_allclose(sign * t_out[0], j_out[0], rtol=0, atol=1e-10 if x64 else 1e-5)


@pytest.mark.parametrize("x64", [False, True])
def test_decompose_and_refine(x64):
    ndt, tdt = _dtypes(x64)
    r1, r2, valid = essential_scene()
    r1, r2 = r1.astype(ndt), r2.astype(ndt)
    key = jax.random.PRNGKey(1)
    with jax.enable_x64(x64):
        je, jmask, _ = jr.ransac_essential(key, jnp.asarray(r1), jnp.asarray(r2),
                                           jnp.asarray(valid), threshold=1e-5)
        j_r, j_t, j_n = jr.decompose_essential(je, jnp.asarray(r1), jnp.asarray(r2), jmask)
        # From a perturbed start, so the refinement has work to do.
        r0 = np.asarray(j_r) @ np.asarray(jr_rot(0.01), ndt)
        t0 = np.asarray(j_t) + np.asarray([0.02, -0.01, 0.0], ndt)
        t0 = t0 / np.linalg.norm(t0)
        w = np.asarray(jmask).astype(ndt)
        jref = jr.refine_relative_pose(jnp.asarray(r0), jnp.asarray(t0), jnp.asarray(r1),
                                       jnp.asarray(r2), jnp.asarray(w), iterations=10)
    tr1, tr2 = torch.from_numpy(r1), torch.from_numpy(r2)
    t_r, t_t, t_n = tr.decompose_essential(torch.from_numpy(np.array(je)), tr1, tr2,
                                           torch.from_numpy(np.array(jmask)))
    tol = 1e-10 if x64 else 1e-5
    np.testing.assert_allclose(t_r.numpy(), np.asarray(j_r), rtol=0, atol=tol)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(j_t), rtol=0, atol=tol)
    assert int(t_n) == int(j_n) == int(np.asarray(jmask).sum())
    # The same E with its sign flipped decomposes to the same pose.
    f_r, f_t, f_n = tr.decompose_essential(-torch.from_numpy(np.array(je)), tr1, tr2,
                                           torch.from_numpy(np.array(jmask)))
    np.testing.assert_allclose(f_r.numpy(), np.asarray(j_r), rtol=0, atol=tol)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(j_t), rtol=0, atol=tol)
    tref = tr.refine_relative_pose(torch.from_numpy(r0), torch.from_numpy(t0), tr1, tr2,
                                   torch.from_numpy(w), iterations=10)
    assert tref[0].dtype == tdt and tref[2].dtype == tdt
    np.testing.assert_allclose(tref[0].numpy(), np.asarray(jref[0]), rtol=0, atol=tol)
    np.testing.assert_allclose(tref[1].numpy(), np.asarray(jref[1]), rtol=0, atol=tol)
    # The scene is noiseless: both costs end at rounding level.
    np.testing.assert_allclose(float(tref[2]), float(jref[2]), rtol=0,
                               atol=1e-28 if x64 else 1e-12)


def jr_rot(angle):
    return np.array([[np.cos(angle), -np.sin(angle), 0], [np.sin(angle), np.cos(angle), 0],
                     [0, 0, 1]])


def test_all_unmatched():
    """No point matched: JAX's logits are -1e30 everywhere, which swallow
    its Gumbel noise, so every drawn index is 0. The port's draw gives the
    same without raising (``torch.multinomial`` would on a zero row) and
    RANSAC returns no inlier, as JAX's."""
    r1, r2, _ = essential_scene()
    r1, r2 = r1.astype(np.float32), r2.astype(np.float32)
    none = np.zeros(len(r1), bool)
    key = jax.random.PRNGKey(5)
    idx = _jax_samples(key, 512, 8, len(r1), none)
    gen = torch.Generator().manual_seed(0)
    own = tr.draw_samples(gen, 512, 8, torch.from_numpy(none)).numpy()
    np.testing.assert_array_equal(own, idx)
    assert not idx.any()
    j_out = [np.asarray(a) for a in jr.ransac_essential(
        key, jnp.asarray(r1), jnp.asarray(r2), jnp.asarray(none), threshold=1e-5)]
    for samples in (torch.from_numpy(idx), None):
        t_out = [a.numpy() for a in tr.ransac_essential(
            gen, torch.from_numpy(r1), torch.from_numpy(r2), torch.from_numpy(none),
            threshold=1e-5, samples=samples)]
        assert int(t_out[2]) == int(j_out[2]) == 0
        assert not t_out[1].any() and not j_out[1].any()
        assert np.isfinite(t_out[0]).all()


def test_sample_indices():
    """The integer inverse-CDF draw: only weighted indices, uniform over
    them, with replacement, the same on any device for the same uniforms."""
    w = torch.zeros(50, dtype=torch.bool)
    w[[3, 7, 8, 40]] = True
    u = torch.rand((2000, 8), generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    idx = tr.sample_indices(u, w)
    assert idx.dtype == torch.int64 and tuple(idx.shape) == (2000, 8)
    vals, counts = torch.unique(idx, return_counts=True)
    assert vals.tolist() == [3, 7, 8, 40]
    assert counts.min() > 0.2 * idx.numel() and counts.max() < 0.3 * idx.numel()
    # Repeats within a sample stay (JAX draws each column on its own).
    assert (~torch.from_numpy(_distinct(idx.numpy()))).any()
    # Edges of [0, 1).
    edge = torch.tensor([[0.0, 1.0 - 2**-53]], dtype=torch.float64)
    assert tr.sample_indices(edge, w).tolist() == [[3, 40]]
    # One weighted point.
    one = torch.zeros(50, dtype=torch.bool)
    one[49] = True
    assert bool((tr.sample_indices(u, one) == 49).all())
