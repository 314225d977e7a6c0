"""The integer candidate masks (``kernels/masks.py``): the plain version and
the kernel's torch twin bitwise against the JAX ``layer_score_masks``.

Kernel ``score_masks`` runs on the card only (``test_torch_gpu.py`` holds
it against the plain version there). Here ``score_masks_plain`` (reached
through ``layer_score_masks`` on CPU tensors) and ``score_masks_twin`` (the
kernel's per-pixel arithmetic: the 2-D test, the axis terms by truncating
division, the probes at the survivors only) are held bit for bit against
the JAX package on seeded uint8 frames of odd shapes, whose layers reach
the extrapolating edge (u = -1/D) and the undefined taps: smoothed noise,
a flat frame (ties everywhere; at threshold 0 the zero fill decides) and a
frame of sharp bright boxes (large negative scores along their edges).

The JAX reference is jitted, one program a (shape, octaves, threshold)
over the three frames at once: its masks are integer arithmetic, so jit
and eager agree, and its fused and unfused masks are one computation off
the TPU (``harris_score_mask_fused`` falls back to ``harris_score_i32`` and
``maxima2d_mask``), so each program checks the port with and without
``fused_mask``. A JAX-free test holds the twin against the plain version
over the whole grid of cases and on synthetic score maps at the ends of
the int32 range.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.detect import scale_space as jss  # noqa: E402
from ethzasl_brisk_tpu_torch.detect import scale_space as tss  # noqa: E402
from ethzasl_brisk_tpu_torch.frames import bench_frames  # noqa: E402
from ethzasl_brisk_tpu_torch.kernels import masks as km  # noqa: E402
from ethzasl_brisk_tpu_torch.kernels.harris import (  # noqa: E402
    harris_score_i32,
    harris_score_mask_i32,
)
from tests import _mask_cases as mask_cases  # noqa: E402

SHAPES = ((61, 83), (96, 130))
# One JAX program a case: octaves 2 on both shapes (every kind of layer:
# above only, both, below only), 1 and 0 on one; the thresholds alternate,
# the JAX side's fused flag too.
JAX_CASES = [
    ((61, 83), 0, 20, False), ((61, 83), 2, 0, True),
    ((96, 130), 1, 0, True), ((96, 130), 2, 20, False),
]


def frames_of(h: int, w: int) -> np.ndarray:
    """(3, h, w) uint8: smoothed noise, a flat frame, sharp bright boxes."""
    rng = np.random.default_rng(h * 1000 + w)
    noise = bench_frames(1, h, w, seed=h + w)[0]
    flat = np.full((h, w), 77, np.uint8)
    boxes = np.full((h, w), 40, np.uint8)
    for _ in range(4):
        y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
        boxes[y : y + rng.integers(4, 20), x : x + rng.integers(4, 20)] = 220
    return np.stack([noise, flat, boxes])


def maps_of(n_layers: int):
    return [(tss.layer_geometry(i).above_map, tss.layer_geometry(i).below_map)
            for i in range(n_layers)]


def port_inputs(frames: np.ndarray, octaves: int, thr: int, fused: bool):
    """(scores, maps, K3's masks or None) of the port's CPU pyramid."""
    n_layers = max(2 * octaves, 1)
    pyr = tss.build_pyramid(torch.from_numpy(frames), n_layers)
    if fused:
        pairs = [harris_score_mask_i32(p, thr) for p in pyr]
        return [p[0] for p in pairs], maps_of(n_layers), [p[1] for p in pairs]
    return [harris_score_i32(p) for p in pyr], maps_of(n_layers), None


@pytest.fixture(scope="module")
def jax_masks():
    """The JAX masks of every JAX_CASES entry, (L, 3, h, w) per case."""
    out = {}
    for shape, octaves, thr, fused in JAX_CASES:
        cfg = jss.DetectorConfig(octaves=octaves, absolute_threshold=float(thr),
                                 fused_mask=fused)
        frames = jnp.asarray(frames_of(*shape))
        run = jax.jit(jax.vmap(lambda im, cfg=cfg: jss.layer_score_masks(im, cfg)[1]))
        # Integer work: XLA's optimisation level changes the compile time only.
        run = run.lower(frames).compile({"xla_backend_optimization_level": 0})
        out[(shape, octaves, thr)] = [np.asarray(m) for m in run(frames)]
    return out


@pytest.mark.parametrize("fused", [False, True], ids=["2d-mask", "fused"])
@pytest.mark.parametrize("shape,octaves,thr", [c[:3] for c in JAX_CASES],
                         ids=[f"{c[0][0]}x{c[0][1]}-oct{c[1]}-thr{c[2]}" for c in JAX_CASES])
def test_masks_match_jax(jax_masks, shape, octaves, thr, fused):
    """``layer_score_masks`` on the CPU (the plain version) and the twin,
    each layer of each frame bit for bit against JAX."""
    frames = frames_of(*shape)
    ref = jax_masks[(shape, octaves, thr)]
    cfg = tss.DetectorConfig(octaves=octaves, absolute_threshold=float(thr), fused_mask=fused)
    _, plain = tss.layer_score_masks(tss.build_pyramid(torch.from_numpy(frames), cfg.n_layers),
                                     cfg)
    scores, maps, base = port_inputs(frames, octaves, thr, fused)
    twin = km.score_masks_twin(scores, thr, maps, base)
    assert len(plain) == len(twin) == len(ref) == cfg.n_layers
    for i, (p, t, r) in enumerate(zip(plain, twin, ref)):
        np.testing.assert_array_equal(p.numpy(), r, err_msg=f"plain, layer {i}")
        np.testing.assert_array_equal(t.numpy(), r, err_msg=f"twin, layer {i}")
    # The cases decide something: noise keeps candidates on every layer,
    # the flat frame at threshold 0 keeps its whole interior on layer 0.
    assert all(int(r[0].sum()) > 0 for r in ref)
    h, w = shape
    assert int(ref[0][1].sum()) == (0 if thr else (h - 4) * (w - 4))


@pytest.mark.parametrize("fused", [False, True], ids=["2d-mask", "fused"])
@pytest.mark.parametrize("thr", [0, 20])
@pytest.mark.parametrize("octaves", [0, 1, 2, 3])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_twin_matches_plain(shape, octaves, thr, fused):
    """The twin against the plain version over the whole grid of cases."""
    frames = frames_of(*shape)
    scores, maps, base = port_inputs(frames, octaves, thr, fused)
    plain = km.score_masks_plain(scores, thr, maps, None if base is None else
                                 [m.clone() for m in base])
    twin = km.score_masks_twin(scores, thr, maps, base)
    for i, (p, t) in enumerate(zip(plain, twin)):
        assert torch.equal(p, t), f"layer {i}"


@pytest.mark.parametrize("kind", mask_cases.KINDS)
def test_twin_matches_plain_on_synthetic_scores(kind):
    """Score maps no Harris frame gives (``tests/_mask_cases.py``): int32
    extremes, wide ties and all-negative maps, over 4 layers."""
    scores = [torch.from_numpy(s) for s in mask_cases.synthetic_scores(kind)]
    maps = maps_of(len(scores))
    for thr in mask_cases.THRESHOLDS:
        plain = km.score_masks_plain(scores, thr, maps)
        twin = km.score_masks_twin(scores, thr, maps)
        for i, (p, t) in enumerate(zip(plain, twin)):
            assert torch.equal(p, t), f"thr {thr}, layer {i}"
    assert any(int(p.sum()) for p in km.score_masks_plain(scores, -(2**31), maps))


def test_score_masks_routes_cpu_to_plain_and_cuda_needs_a_card():
    """On CPU tensors ``score_masks`` is the plain version; the kernel's
    wrapper takes CUDA tensors only, and checks its threshold."""
    scores, maps, _ = port_inputs(frames_of(61, 83)[:1], 2, 20, False)
    got = km.score_masks(scores, 20, maps)
    for g, p in zip(got, km.score_masks_plain(scores, 20, maps)):
        assert torch.equal(g, p)
    with pytest.raises(ValueError, match="CUDA"):
        km.score_masks_cuda(scores, 20, maps)
    with pytest.raises(ValueError, match="int32"):
        km.score_masks_cuda(scores, 2**31, maps)


def test_masks_table_matches_the_kernel_source():
    """The wrapper's layer table, the staging sizes and the kernel's
    constants agree: 8 layers a launch, 17 int64 fields a layer (5 of the
    layer, 6 a neighbour), the tile and the staged rows; and four CTAs an
    SM hold their staging on the fused path."""
    import pathlib
    import re

    src = (pathlib.Path(km.__file__).parents[1] / "csrc" / "masks.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kMaxLayers"]) == km.MAX_LAYERS
    assert int(consts["kFields"]) == 5 + 2 * 6
    assert int(consts["kThreads"]) == km.THREADS
    assert (int(consts["kTileW"]), int(consts["kTileH"])) == (km.TILE_W, km.TILE_H)
    assert (int(consts["kRowWords"]), int(consts["kMaskRowBytes"])) == (
        km.ROW_WORDS, km.MASK_ROW_BYTES)
    assert 4 * (km.staged_bytes(True) + 8192 + 1024) <= 233472


@pytest.mark.parametrize("layer", range(6))
def test_patch_holds_every_probe(layer):
    """Each layer's above map fits the kernel, as its entry checks: the map
    shrinks, so a survivor's 9 probes take at most a 4 x 4 patch. Replayed
    on every pixel of a VGA layer: each probe's taps lie in the survivor's
    patch, at offsets 0-2 of its first row and column."""
    g = tss.layer_geometry(layer)
    a, b, d = g.above_map
    assert a < d
    h, w = 480, 640
    rows, cols = -(-h * 2 // 3), -(-w * 2 // 3)  # at least the layer above's size
    y, x = torch.meshgrid(torch.arange(2, h - 2), torch.arange(2, w - 2), indexing="ij")
    y, x = y.reshape(-1), x.reshape(-1)
    pr, pc = km._axis(y - 1, rows, a, b, d)[0], km._axis(x - 1, cols, a, b, d)[0]
    for k in range(3):
        v0 = km._axis(y + k - 1, rows, a, b, d)[0]
        u0 = km._axis(x + k - 1, cols, a, b, d)[0]
        assert bool(((v0 - pr >= 0) & (v0 - pr <= 2)).all())
        assert bool(((u0 - pc >= 0) & (u0 - pc <= 2)).all())
