"""Port parity: the AST path's dense integer maps against the JAX package.

The four AGAST/OAST score maps (at odd and even sizes and on batches),
``vals_run``, ``threshold_map``, a layer's corner and cache maps, the
pyramid, the row-major candidate lists (``jnp.nonzero(size=cap,
fill_value=0)``: order, truncation, fill), ``earliest_toucher_map``,
``_aux_maps`` and ``ast_capacity_diagnostics``. Inputs are smoothed-noise
crops made from a seed as in ``tests/test_ast_parity.py``. Tolerance: bit
for bit, and the same dtypes (int32 maps, bool masks).
"""
import numpy as np
import pytest
import torch
from scipy import ndimage

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.detect import ast_layer as jal  # noqa: E402
from ethzasl_brisk_tpu.detect import ast_scale_space as jas  # noqa: E402
from ethzasl_brisk_tpu.kernels import agast as jag  # noqa: E402
from ethzasl_brisk_tpu_torch.detect import ast_layer as tal  # noqa: E402
from ethzasl_brisk_tpu_torch.detect import ast_scale_space as tas  # noqa: E402
from ethzasl_brisk_tpu_torch.kernels import agast as tag  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port on one thread here: tier-1 runs six workers on few cores,
    and the JAX reference's compiles take the rest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MAPS = ("oast9_16_score_map", "agast5_8_score_map", "agast7_12s_score_map",
        "agast7_12d_score_map")


def crop(h, w, seed, batch=None):
    """Smoothed-noise uint8 crops (tests/test_ast_parity.py:215-230)."""
    rng = np.random.default_rng(seed)
    shape = (h, w) if batch is None else (batch, h, w)
    base = rng.integers(0, 256, shape).astype(np.float32)
    kern = np.ones((3, 3)) / 9.0 if batch is None else np.ones((1, 3, 3)) / 9.0
    return np.clip(ndimage.convolve(base, kern, mode="nearest"), 0, 255).astype(np.uint8)


def _same(got: torch.Tensor, ref, what=""):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape, (what, got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref, err_msg=what)


@pytest.mark.parametrize("name", MAPS)
@pytest.mark.parametrize("shape", [(37, 50), (38, 51), (96, 128)])
def test_score_maps_bitwise(name, shape):
    img = crop(*shape, seed=shape[0])
    ref = getattr(jag, name)(jnp.asarray(img))
    got = getattr(tag, name)(torch.from_numpy(img)[None])
    _same(got[0], ref, name)


@pytest.mark.parametrize("name", MAPS)
def test_score_maps_batch_is_per_frame(name):
    imgs = crop(41, 60, seed=3, batch=3)
    got = getattr(tag, name)(torch.from_numpy(imgs))
    for b in range(3):
        _same(got[b], getattr(jag, name)(jnp.asarray(imgs[b])), f"{name} frame {b}")


@pytest.mark.parametrize("run", [1, 2, 3, 5, 7, 9, 12])
def test_vals_run_bitwise(run):
    vals = np.random.default_rng(run).integers(-300, 300, (16, 5, 7)).astype(np.int16)
    for op_j, op_t in ((jnp.minimum, torch.minimum), (jnp.maximum, torch.maximum)):
        _same(tag.vals_run(torch.from_numpy(vals), run, op_t),
              jag.vals_run(jnp.asarray(vals), run, op_j), f"run {run}")


@pytest.mark.parametrize("shape", [(37, 50), (96, 128)])
def test_threshold_map_bitwise(shape):
    img = crop(*shape, seed=7)
    _same(tal.threshold_map(torch.from_numpy(img)[None])[0], jal.threshold_map(jnp.asarray(img)))


@pytest.mark.parametrize("threshold,lower", [(40, 10), (70, 10), (40, 0)])
@pytest.mark.parametrize("shape", [(37, 50), (96, 128)])
def test_layer_maps_bitwise(shape, threshold, lower):
    img = crop(*shape, seed=11)
    ref = jal.build_ast_layer(jnp.asarray(img), threshold, lower=lower, scale=1.5, offset=0.25)
    got = tal.build_ast_layer(torch.from_numpy(img)[None], threshold, lower=lower,
                              scale=1.5, offset=0.25)
    for f in ("t_star", "thrmap", "corner", "cache"):
        _same(getattr(got, f)[0], getattr(ref, f), f)
    assert (got.scale, got.offset) == (ref.scale, ref.offset)


def test_layer_v1_not_ported():
    """The v1 layer, now ported (the test keeps the name it had while v1
    raised): a constant threshold map, plain OAST 9/16 corners and the
    cache max(t*, 0), bitwise against the JAX layer."""
    img = crop(38, 51, seed=38)
    ref = jal.build_ast_layer(jnp.asarray(img), 30, v1=True)
    got = tal.build_ast_layer(torch.from_numpy(img)[None], 30, v1=True)
    for f in ("t_star", "thrmap", "corner", "cache"):
        _same(getattr(got, f)[0], getattr(ref, f), f)
    assert int(got.corner.sum()) > 0


@pytest.mark.parametrize("octaves", [0, 1, 3])
def test_pyramid_bitwise(octaves):
    img = crop(120, 161, seed=2)
    ref = jas.build_ast_pyramid(jnp.asarray(img), octaves, 40)
    got = tas.build_ast_pyramid(torch.from_numpy(img)[None], octaves, 40)
    assert len(got) == len(ref) == max(2 * octaves, 1)
    for i, (g, r) in enumerate(zip(got, ref)):
        for f in ("img", "t_star", "corner", "cache"):
            _same(getattr(g, f)[0], getattr(r, f), f"layer {i} {f}")
        assert (g.scale, g.offset) == (r.scale, r.offset)


@pytest.mark.parametrize("cap", [1, 50, 400, 3000])
def test_layer_candidates_match_nonzero(cap):
    """Row-major order, truncation at cap and the (0, 0) fill, per frame."""
    imgs = crop(40, 52, seed=5, batch=2)
    layer = tal.build_ast_layer(torch.from_numpy(imgs), 40)
    xs, ys, valid = tas.layer_candidates(layer.corner, cap)
    assert xs.dtype == ys.dtype == torch.int32 and xs.shape == (2, cap)
    for b in range(2):
        ry, rx = jnp.nonzero(jnp.asarray(layer.corner[b].numpy()), size=cap, fill_value=0)
        n = int(layer.corner[b].sum())
        _same(xs[b], np.asarray(rx).astype(np.int32), "xs")
        _same(ys[b], np.asarray(ry).astype(np.int32), "ys")
        _same(valid[b], np.arange(cap) < n, "valid")


def test_earliest_toucher_map_bitwise():
    img = crop(96, 128, seed=13)
    ref = jas.earliest_toucher_map(jal.build_ast_layer(jnp.asarray(img), 40))
    got = tas.earliest_toucher_map(tal.build_ast_layer(torch.from_numpy(img)[None], 40))
    _same(got[0], ref)


@pytest.mark.parametrize("octaves", [1, 2])
def test_aux_maps_bitwise(octaves):
    """_aux_maps from seeded pass-1 flags over every layer's candidates:
    e_query, e_patch and prefill bit for bit (the last layer's 4x4 and
    2x2 footprints, the octave and intra prefill windows, early exits)."""
    img = crop(96, 128, seed=17)
    jl = jas.build_ast_pyramid(jnp.asarray(img), octaves, 40)
    tl = tas.build_ast_pyramid(torch.from_numpy(img)[None], octaves, 40)
    rng = np.random.default_rng(octaves)
    jcand, tcand, jp1, tp1 = [], [], [], []
    for la in tl:
        xs, ys, valid = tas.layer_candidates(la.corner, 600)
        tcand.append((xs, ys, valid))
        jcand.append(tuple(jnp.asarray(a[0].numpy()) for a in (xs, ys, valid)))
        flags = {k: rng.random(600) < 0.6 for k in ("is2d", "patch_touched", "above_ok")}
        jp1.append({k: jnp.asarray(v) for k, v in flags.items()})
        tp1.append({k: torch.from_numpy(v)[None] for k, v in flags.items()})
    ref = jas._aux_maps(jl, jcand, jp1)
    got = tas._aux_maps(tl, tcand, tp1)
    for i, (g, r) in enumerate(zip(got, ref)):
        for name, a, b in zip(("e_query", "e_patch", "prefill"), g, r):
            _same(a[0], b, f"layer {i} {name}")
        if i > 0:
            assert bool(g[2].any())


@pytest.mark.parametrize("caps", [2048, (512, 256, 128, 64), (200, 60, 20, 5)])
def test_capacity_diagnostics_bitwise(caps):
    imgs = crop(96, 128, seed=19, batch=2)
    got = tas.ast_capacity_diagnostics(torch.from_numpy(imgs), 40, 2, caps)
    for b in range(2):
        ref = jas.ast_capacity_diagnostics(jnp.asarray(imgs[b]), 40, 2, caps)
        _same(got.ok[b], ref.ok, "ok")
        _same(got.corner_counts[b], ref.corner_counts, "counts")
        _same(got.cand_caps, ref.cand_caps, "caps")
    if caps == (200, 60, 20, 5):
        assert not bool(got.ok.any())
