"""Port parity: the float32 angle chain (``core/atan2f.py``,
``core/sincosf.py``, ``describe/orientation.py``) against the JAX package.

* ``atan2f_plain`` against ``jnp.arctan2`` bit for bit: 100,000 integer
  pairs in +-200,000 (the long-pair sums' range), 100,000 float pairs with
  magnitudes 1e-8 to 1e8 and either sign, the signed-zero and special grid
  (+-0, +-1, +-3, +-1e-30, +-inf, NaN), and +-1 and 2 ULP around every
  breakpoint of ``atanf`` (7/16, 11/16, 19/16, 39/16, 2^25, 2^-29) as the
  ratio ``y / x`` and around ``x == 1``.
* ``sincosf_plain`` against ``jnp.sin`` and ``jnp.cos`` bit for bit on
  angles of every reduction branch (below 2^-12 and pi/4, below 120, and
  up to 1e38), the branch edges, inf and NaN.
* ``orientation_plain`` against the JAX describe's chain as its jitted
  entry points compile it (the lines of ``_describe_core`` under
  ``jax.jit``), and, op by op, as the 16-bit path runs it: angle and theta
  bit for bit. Then ``extract_descriptors_batch`` on keypoints whose
  angles sit one ULP around the rotation-bin edges: angles, theta (through
  the descriptors) and descriptors bit for bit.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.core.keypoints import KeyPoints as JaxKeyPoints  # noqa: E402
from ethzasl_brisk_tpu.core.pattern import brisk_v2_pattern as jax_v2_pattern  # noqa: E402
from ethzasl_brisk_tpu.describe import extractor as jext  # noqa: E402
from ethzasl_brisk_tpu_torch.core.atan2f import atan2f, atan2f_plain  # noqa: E402
from ethzasl_brisk_tpu_torch.core.keypoints import KeyPoints  # noqa: E402
from ethzasl_brisk_tpu_torch.core.sincosf import sincosf, sincosf_plain  # noqa: E402
from ethzasl_brisk_tpu_torch.describe.extractor import (  # noqa: E402
    PATTERN_FIELDS,
    extract_descriptors_batch,
    pattern_from_numpy,
)
from ethzasl_brisk_tpu_torch.describe.orientation import orientation, orientation_plain  # noqa: E402
from ethzasl_brisk_tpu_torch.frames import bench_frames  # noqa: E402

N_ROT = 1024


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _same_atan2(y, x):
    y, x = np.asarray(y, np.float32), np.asarray(x, np.float32)
    ref = np.asarray(jnp.arctan2(jnp.asarray(y), jnp.asarray(x)))
    got = atan2f_plain(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    same = (_bits(got) == _bits(ref)) | (np.isnan(got) & np.isnan(ref))
    assert same.all(), (y[~same][:5], x[~same][:5], got[~same][:5], ref[~same][:5])
    return got


def test_atan2f_integer_pairs():
    rng = np.random.default_rng(0)
    y, x = rng.integers(-200_000, 200_001, (2, 100_000))
    got = _same_atan2(y, x)
    # torch's own chain is another one: it differs on a sixth of these.
    theirs = torch.atan2(torch.from_numpy(y.astype(np.float32)),
                         torch.from_numpy(x.astype(np.float32))).numpy()
    assert (_bits(theirs) != _bits(got)).mean() > 0.1


def test_atan2f_float_pairs():
    rng = np.random.default_rng(1)
    mag = 10.0 ** rng.uniform(-8, 8, (2, 100_000))
    sign = rng.choice([-1.0, 1.0], (2, 100_000))
    _same_atan2(*(mag * sign))


def test_atan2f_specials():
    sp = np.array([0.0, -0.0, 1.0, -1.0, 3.0, -3.0, 1e-30, -1e-30, np.inf, -np.inf, np.nan],
                  np.float32)
    y, x = np.meshgrid(sp, sp)
    _same_atan2(y.ravel(), x.ravel())


@pytest.mark.parametrize("bp", [7 / 16, 11 / 16, 19 / 16, 39 / 16, 2.0**25, 2.0**-29, 1.0])
def test_atan2f_breakpoints(bp):
    bits = np.float32(bp).view(np.int32)
    near = (bits + np.arange(-2, 3, dtype=np.int32)).view(np.float32)
    ratio = np.concatenate([near, -near])
    # x a power of two keeps y / x exactly the ratio; x == 1 takes atanf(y).
    x = np.array([1.0, 2.0, -2.0, 0.5, -0.5], np.float32)
    yy, xx = np.meshgrid(ratio, x)
    _same_atan2(yy * xx, xx)
    _same_atan2(np.ones_like(ratio), ratio)        # |y / x| = 1 / ratio
    _same_atan2(ratio, np.ones_like(ratio) * np.float32(np.nextafter(1.0, 2.0, dtype=np.float32)))


def test_sincosf():
    rng = np.random.default_rng(2)
    mag = 10.0 ** rng.uniform(-10, 38, 100_000)
    a = np.concatenate([
        rng.uniform(-7, 7, 100_000), rng.uniform(-200, 200, 50_000),
        mag * rng.choice([-1.0, 1.0], mag.size),
        [0.0, -0.0, 2.0**-12, np.pi / 4, 0.75, 119.99999, 120.0, -120.0, np.inf, -np.inf, np.nan],
    ]).astype(np.float32)
    s, c = sincosf_plain(torch.from_numpy(a))
    for got, fn in ((s.numpy(), jnp.sin), (c.numpy(), jnp.cos)):
        ref = np.asarray(fn(jnp.asarray(a)))
        same = (_bits(got) == _bits(ref)) | (np.isnan(got) & np.isnan(ref))
        assert same.all(), (a[~same][:5], got[~same][:5], ref[~same][:5])
    # The CPU tensors take the plain versions.
    s2, c2 = sincosf(torch.from_numpy(a))
    assert torch.equal(s2.view(torch.int32), s.view(torch.int32))
    assert torch.equal(c2.view(torch.int32), c.view(torch.int32))


def _jax_chain(d0, d1, given, need):
    """The lines of the JAX ``_describe_core`` that turn the long-pair sums
    into angle and theta (``ethzasl_brisk_tpu/describe/extractor.py``)."""
    computed = jnp.arctan2(d1.astype(jnp.float32), d0.astype(jnp.float32)) / np.float32(np.pi) \
        * 180.0
    angle = jnp.where(need, computed, given)
    theta = jext._trunc_i32(N_ROT * angle / 360.0 + 0.5)
    theta = jnp.where(theta < 0, theta + N_ROT, theta)
    theta = jnp.where(theta >= N_ROT, theta - N_ROT, theta)
    return angle, theta


def _edge_angles(n_each=3):
    """Given angles one and two ULP around every rotation-bin edge."""
    edges = ((np.arange(-N_ROT, N_ROT) - 0.5) * 360.0 / N_ROT).astype(np.float32)
    b = edges.view(np.int32)
    return np.concatenate([(b + d).view(np.float32) for d in range(-n_each, n_each + 1)])


@pytest.mark.parametrize("op_by_op", [False, True], ids=["compiled", "op_by_op"])
def test_orientation_matches_the_jax_chain(op_by_op):
    rng = np.random.default_rng(4)
    n = 60_000
    d0, d1 = rng.integers(-200_000, 200_001, (2, n)).astype(np.int32)
    given = np.concatenate([_edge_angles(), rng.uniform(-360, 360, n)]).astype(np.float32)[:n]
    need = rng.random(n) < 0.5
    inputs = [jnp.asarray(v) for v in (d0, d1, given, need)]
    if op_by_op:
        with jax.disable_jit():
            ja, jt = _jax_chain(*inputs)
    else:
        ja, jt = jax.jit(_jax_chain)(*inputs)
    args = [torch.from_numpy(v) for v in (d0, d1, given, need)]
    ta, tt = orientation_plain(*args, op_by_op=op_by_op)
    np.testing.assert_array_equal(_bits(ta.numpy()), _bits(ja))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    ta2, tt2 = orientation(*args, op_by_op=op_by_op)
    assert torch.equal(ta2, ta) and torch.equal(tt2, tt)


def test_describe_at_bin_edges_matches_jax():
    """``extract_descriptors_batch`` with given angles around the bin
    edges and computed ones: angle and descriptors bit for bit."""
    imgs = bench_frames(2, 120, 160, seed=4)
    jpat = jext.DevicePattern.from_host(jax_v2_pattern())
    pat = pattern_from_numpy({f: np.asarray(getattr(jpat, f)) for f in PATTERN_FIELDS})
    rng = np.random.default_rng(5)
    k = 400
    edges = _edge_angles(1)
    angle = np.where(rng.random((2, k)) < 0.7, rng.choice(edges, (2, k)), -1.0)
    f = dict(x=rng.uniform(30, 130, (2, k)), y=rng.uniform(30, 90, (2, k)),
             size=rng.uniform(8, 20, (2, k)), angle=angle, response=np.ones((2, k)),
             octave=np.zeros((2, k)), valid=np.ones((2, k), bool))
    f = {n: v.astype(np.int32 if n == "octave" else bool if n == "valid" else np.float32)
         for n, v in f.items()}
    jkp, jdesc = jext.extract_descriptors_batch(
        jpat, jnp.asarray(imgs), JaxKeyPoints(**{n: jnp.asarray(v) for n, v in f.items()}),
        sampler="gather")
    kp, desc = extract_descriptors_batch(pat, torch.from_numpy(imgs),
                                         KeyPoints(**{n: torch.from_numpy(v) for n, v in f.items()}))
    valid = np.asarray(jkp.valid)
    assert valid.sum() > 500
    np.testing.assert_array_equal(kp.valid.numpy(), valid)
    np.testing.assert_array_equal(_bits(kp.angle.numpy()[valid]), _bits(np.asarray(jkp.angle)[valid]))
    np.testing.assert_array_equal(desc.numpy(), np.asarray(jdesc).view(np.int32))


def test_atan2f_picks_by_device():
    y = torch.tensor([1.0, -2.0, 3.0])
    x = torch.tensor([0.5, 0.25, -4.0])
    assert torch.equal(atan2f(y, x), atan2f_plain(y, x))
    with pytest.raises(TypeError):
        atan2f_plain(y.double(), x.double())
