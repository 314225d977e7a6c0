"""Port parity: ``describe/rotated.py``, the uint8 describe in one kernel
(kernel ``describe_rotated``'s plain version: both samplings, the
gradient, the chain and the words), and ``_describe_core`` on that route,
against the JAX package; the pattern tables the kernel takes, packed.

Each case runs the JAX ``extract_descriptors_compact`` and the port's on
the same smoothed-noise frames and random keypoints: v2; v1 with its
rounding and 16 words; pattern scale 0.5, where the bilinear branch is
live; ``rotation_invariant=False``; given angles beside computed ones; a
``.ptn`` pattern written here with 300 short pairs (a partial last word)
and 428 long ones. Tolerance: bit for bit, on valid, every keypoint
field, the angle of every valid slot and every descriptor word; the angle
of a slot that describe leaves invalid is outside parity
(``_describe_core``'s docstring).

The JAX reference is its ``gather`` sampler (as
``tests/test_torch_sampler.py`` runs it) and its ``patch_ms`` sampler at
128 x 128 patches, which frames of 160 rows hold. The two disagree on one
sample of one describable keypoint here (slot 12 of frame 0: the gather
sampler's sample 46 of the unrotated pattern, where the Pallas sampler in
interpret mode agrees with ``patch_ms`` and the port; ROADMAP Queue 3,
item 3). So the port is held to ``patch_ms`` on every slot and to
``gather`` on every slot where the two agree, and the two may disagree on
one slot at most.
"""
import functools
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.core import pattern as jpat  # noqa: E402
from ethzasl_brisk_tpu.core.keypoints import KeyPoints as JaxKeyPoints  # noqa: E402
from ethzasl_brisk_tpu.describe import extractor as jext  # noqa: E402
from ethzasl_brisk_tpu_torch.core import pattern as tpat  # noqa: E402
from ethzasl_brisk_tpu_torch.core.keypoints import KeyPoints  # noqa: E402
from ethzasl_brisk_tpu_torch.describe import extractor, rotated  # noqa: E402
from ethzasl_brisk_tpu_torch.describe.extractor import (  # noqa: E402
    DevicePattern,
    _describable_mask,
    extract_descriptors_compact,
)
from ethzasl_brisk_tpu_torch.frames import bench_frames  # noqa: E402

B, H, W, K, CAP = 3, 160, 200, 40, 48
CSRC = extractor.__file__.rsplit("/describe/", 1)[0] + "/csrc/describe.cu"

# name: (pattern, pattern_scale, v1_rounding, rotation_invariant, given angles)
CASES = {
    "v2": ("v2", 1.0, False, True, False),
    "v1": ("v1", 1.0, True, True, False),
    "scale_0.5": ("v2", 0.5, False, True, False),
    "no_rotation": ("v2", 1.0, False, False, True),
    "given_angles": ("v2", 1.0, False, True, True),
    "ptn": ("ptn", 1.0, False, True, False),
}


def _write_ptn(path) -> str:
    """A ``.ptn`` pattern (InitFromStream's token order) from the v2 base
    points, their sigmas scaled by 0.9, with the first 300 of v2's short
    pairs and every other of its long pairs."""
    with np.load(tpat._PATTERN_NPZ) as data:
        pts, short, long = data["points"], data["short_pairs"][:300], data["long_pairs"][::2]
    pts = pts * np.array([1.0, 1.0, 0.9])
    lines = [str(len(pts))] + [" ".join(repr(float(v)) for v in p) for p in pts]
    lines += [str(len(short))] + [f"{i} {j}" for i, j in short]
    lines += [str(len(long))] + [f"{i} {j}" for i, j in long]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@functools.lru_cache(maxsize=None)
def _patterns(kind: str, scale: float, tmp: str):
    """The (port, JAX) pattern tables of a case."""
    if kind == "ptn":
        import pathlib

        path = _write_ptn(pathlib.Path(tmp) / "subset.ptn")
        host, jhost = tpat.pattern_from_file(path, scale), jpat.pattern_from_file(path, scale)
    else:
        host = getattr(tpat, f"brisk_{kind}_pattern")(scale)
        jhost = getattr(jpat, f"brisk_{kind}_pattern")(scale)
    return DevicePattern.from_host(host), jext.DevicePattern.from_host(jhost)


def _fields(given: bool, scale: float):
    rng = np.random.default_rng(18)
    sizes = [6.0, 7.0, 8.0, 12.0, 18.0] if scale < 1 else [12.0, 18.0, 24.0, 36.0]
    angle = np.full((B, K), -1.0, np.float32)
    if given:
        angle = np.where(rng.random((B, K)) < 0.5, rng.uniform(-180, 180, (B, K)), -1.0)
    return dict(
        x=rng.uniform(2, W - 2, (B, K)).astype(np.float32),
        y=rng.uniform(2, H - 2, (B, K)).astype(np.float32),
        size=rng.choice(sizes, (B, K)).astype(np.float32),
        angle=angle.astype(np.float32),
        response=rng.random((B, K)).astype(np.float32),
        octave=rng.integers(0, 4, (B, K)).astype(np.int32),
        valid=rng.random((B, K)) < 0.85,
    )


@pytest.fixture(scope="module")
def ptn_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ptn"))


@functools.lru_cache(maxsize=None)
def _jax_case(name: str, tmp: str, sampler: str):
    """The JAX package's (fields, words) of a case with ``sampler``."""
    kind, scale, v1, rot, given = CASES[name]
    _, jpat_dev = _patterns(kind, scale, tmp)
    f = _fields(given, scale)
    jkp, jdesc, jn = jext.extract_descriptors_compact(
        jpat_dev, jnp.asarray(bench_frames(B, H, W)),
        JaxKeyPoints(**{n: jnp.asarray(v) for n, v in f.items()}),
        capacity=CAP, sampler=sampler, patch_h=128, patch_w=128, rotation_invariant=rot,
        v1_rounding=v1, with_diagnostics=True,
    )
    fields = {n: np.asarray(getattr(jkp, n)) for n in f}
    return fields, np.asarray(jdesc).view(np.int32), int(jn)


def _references(name: str, tmp: str):
    """Both JAX samplers' results and the (B, K) slots where they agree."""
    (gf, gd, gn), (pf, pd, pn) = (_jax_case(name, tmp, s) for s in ("gather", "patch_ms"))
    valid = pf["valid"]
    agree = (gf["valid"] == valid) & (gd == pd).all(-1)
    agree &= ~valid | (gf["angle"].view(np.int32) == pf["angle"].view(np.int32))
    assert gn == pn and (~agree).sum() <= 1, np.argwhere(~agree)
    return (gf, gd), (pf, pd), agree, pn


def _port_case(name: str, tmp: str):
    kind, scale, v1, rot, given = CASES[name]
    pat, _ = _patterns(kind, scale, tmp)
    f = _fields(given, scale)
    kps = KeyPoints(**{n: torch.from_numpy(v) for n, v in f.items()})
    return pat, extract_descriptors_compact(
        pat, torch.from_numpy(bench_frames(B, H, W)), kps, capacity=CAP,
        rotation_invariant=rot, v1_rounding=v1, with_diagnostics=True)


@pytest.mark.parametrize("name", list(CASES))
def test_describe_core_matches_jax(name, ptn_dir):
    """``extract_descriptors_compact`` (``_describe_core`` on the K2 route,
    ``describe_rotated``'s plain version on the CPU) against the JAX
    package, bit for bit."""
    gather, patch_ms, agree, jn = _references(name, ptn_dir)
    pat, (kp, desc, n) = _port_case(name, ptn_dir)
    valid = patch_ms[0]["valid"]
    assert int(n) == jn and valid.sum() >= 20, (int(n), valid.sum())
    for (jfields, jdesc), slots in ((patch_ms, np.ones_like(agree)), (gather, agree)):
        np.testing.assert_array_equal(kp.valid.numpy()[slots], jfields["valid"][slots])
        for field in ("x", "y", "size", "response", "octave"):
            np.testing.assert_array_equal(getattr(kp, field).numpy(), jfields[field],
                                          err_msg=field)
        np.testing.assert_array_equal(kp.angle.numpy()[slots & valid].view(np.int32),
                                      jfields["angle"][slots & valid].view(np.int32))
        np.testing.assert_array_equal(desc.numpy()[slots], jdesc[slots])
    assert desc.shape[-1] == pat.descriptor_words
    kind, scale, v1, rot, given = CASES[name]
    if given:
        assert (valid & (_fields(given, scale)["angle"] != -1.0)).sum() >= 5, "given angles"
    if kind == "ptn":
        # 300 bits in 12 words: word 9 holds bits 288-299, words 10-11 none.
        assert pat.short_i.shape[0] == 300 and pat.long_i.shape[0] == 428
        assert (desc[..., 10:] == 0).all() and ((desc[..., 9] >> 12) == 0).all()
        assert (desc[..., 9] != 0).any(), "the partial word carries bits"


@pytest.mark.parametrize("name", list(CASES))
def test_describe_rotated_plain_matches_jax(name, ptn_dir, monkeypatch):
    """``describe_rotated_plain`` on the inputs ``_describe_core`` hands it
    (recorded: the integral and the keypoints, no phase-1 values), against
    the JAX package's angle and words at the described slots;
    ``describe_rotated`` on CPU tensors is the plain version."""
    calls = []
    real = extractor.describe_rotated

    def record(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(extractor, "describe_rotated", record)
    gather, patch_ms, agree, _ = _references(name, ptn_dir)
    pat, _ = _port_case(name, ptn_dir)
    (args,) = calls
    angle, desc = rotated.describe_rotated_plain(*args)
    kind, scale, v1, rot, given = CASES[name]
    assert args[3] is rot and args[-1] == v1
    f = _fields(given, scale)
    flat = KeyPoints(**{n: torch.from_numpy(v.reshape(-1)) for n, v in f.items()})
    describable = _describable_mask(pat, H, W, flat)
    sel = torch.sort((~describable).to(torch.uint8), stable=True).indices[:CAP].numpy()
    valid = patch_ms[0]["valid"].reshape(-1)[sel]
    np.testing.assert_array_equal(args[5].numpy(), valid)
    for (jfields, jdesc), slots in ((patch_ms, np.ones_like(valid)), (gather, agree.reshape(-1)[sel])):
        np.testing.assert_array_equal(angle.numpy()[slots & valid].view(np.int32),
                                      jfields["angle"].reshape(-1)[sel][slots & valid].view(np.int32))
        np.testing.assert_array_equal(desc.numpy()[slots], jdesc.reshape(B * K, -1)[sel][slots])
    again = rotated.describe_rotated(*args)
    assert torch.equal(again[0], angle) and torch.equal(again[1], desc)
    if kind == "v2" and scale < 1:
        sigma = rotated.rotated_sampler_args(pat, args[1], args[2], args[4], 0, *args[7:])[5]
        assert int((sigma[torch.from_numpy(valid)] < 0.5).sum()) > 20, "bilinear branch live"


def test_describe_rotated_cuda_rejects_cpu_tensors(ptn_dir, monkeypatch):
    calls = []
    monkeypatch.setattr(extractor, "describe_rotated", lambda *a: calls.append(a) or
                        rotated.describe_rotated_plain(*a))
    _port_case("v2", ptn_dir)
    with pytest.raises(ValueError, match="CUDA"):
        rotated.describe_rotated_cuda(*calls[0])


def test_describe_rotated_cuda_checks_its_inputs():
    """On meta tensors (no card, no build): a pattern whose tables do not
    fit a block's shared memory, a LUT of another rotation count, or an
    input of the wrong type is refused before any launch."""
    from ethzasl_brisk_tpu_torch import _kernels

    def pattern(p, n_long, n_short, n_rot=1024):
        z = dict(device="meta")
        return DevicePattern(
            lut_x=torch.empty((4, n_rot, p), **z), lut_y=torch.empty((4, n_rot, p), **z),
            lut_sigma=torch.empty((4, p), **z),
            lut_scaling=torch.empty((4, p), dtype=torch.int32, **z),
            lut_scaling2=torch.empty((4, p), dtype=torch.int32, **z),
            scale_list=torch.empty((4,), **z), size_list=torch.empty((4,), dtype=torch.int32, **z),
            short_i=torch.empty((n_short,), dtype=torch.int64, **z),
            short_j=torch.empty((n_short,), dtype=torch.int64, **z),
            long_i=torch.empty((n_long,), dtype=torch.int64, **z),
            long_j=torch.empty((n_long,), dtype=torch.int64, **z),
            long_wdx=torch.empty((n_long,), dtype=torch.int32, **z),
            long_wdy=torch.empty((n_long,), dtype=torch.int32, **z))

    def args(p, k=10, angle_dtype=torch.float32):
        m = dict(device="meta")
        return (torch.empty((100, 51), dtype=torch.int32, **m), 49, True,
                torch.empty((k,), dtype=torch.int64, **m), torch.empty((k,), dtype=torch.bool, **m),
                torch.empty((k,), dtype=angle_dtype, **m), torch.empty((k,), **m),
                torch.empty((k,), **m), torch.empty((k,), dtype=torch.int32, **m))

    _kernels.reset_launches()
    with pytest.raises(ValueError, match="shared memory"):
        rotated.describe_rotated_cuda(pattern(66, 20_000, 384), *args(66))
    with pytest.raises(ValueError, match="shared memory"):
        rotated.describe_rotated_cuda(pattern(40_000, 10, 10), *args(40_000, k=1))
    with pytest.raises(ValueError, match="1024 rotations"):
        rotated.describe_rotated_cuda(pattern(66, 856, 384, n_rot=512), *args(66))
    with pytest.raises(ValueError, match="angle"):
        rotated.describe_rotated_cuda(pattern(66, 856, 384), *args(66, angle_dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA"):  # the v2 and v1 tables fit
        rotated.describe_rotated_cuda(pattern(66, 856, 384), *args(66))
    with pytest.raises(ValueError, match="CUDA"):
        rotated.describe_rotated_cuda(pattern(60, 870, 512), *args(60))
    assert not any(_kernels.LAUNCHES.values())


def test_describe_rotated_constants_match_the_kernel():
    """The wrapper's shared-memory sizing uses the kernel's largest tile,
    its opt-in limit, the room it keeps for its static arrays and its
    padding of the packed tables (``csrc/describe.cu``)."""
    src = open(CSRC).read()
    assert int(re.search(r"constexpr int kWarps = (\d+);", src).group(1)) == rotated.WARPS
    assert int(re.search(r"constexpr int kMaxSmem = (\d+);", src).group(1)) == rotated.MAX_SMEM
    assert int(re.search(r"constexpr int kStaticSmem = (\d+);", src).group(1)) == \
        rotated.STATIC_SMEM
    assert "return (3 * L + n_bits + 3) & ~3;" in src
    assert [rotated.table_ints(n, b) for n, b in ((856, 384), (870, 512), (1, 0), (0, 0))] == \
        [2952, 3124, 4, 0]
    # The static arrays: three tiles' keypoint inputs, the partial sums and
    # their counts, the bins and the mbarrier.
    assert 3 * 6 * 4 * rotated.WARPS + 3 * 4 * rotated.WARPS + 4 * rotated.WARPS + 8 <= \
        rotated.STATIC_SMEM
    assert "return sizeof(int32_t) * ((size_t)table_ints(L, n_bits) + 2 * (size_t)T * P);" in src
    assert rotated.dynamic_smem(4, 66, 856, 384) == 4 * (2952 + 2 * 4 * 66)


def test_describe_routes(monkeypatch):
    """The uint8 describe goes through ``describe_rotated`` once a call and
    K2 never (both samplings are the kernel's); ``angle_exact`` keeps K2's
    two samplings, and the 16-bit image the orientation step."""
    seen = {"rotated": 0, "k2": 0, "orientation": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            seen[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(extractor, "describe_rotated",
                        counting("rotated", extractor.describe_rotated))
    monkeypatch.setattr(extractor, "smoothed_intensity_fused",
                        counting("k2", extractor.smoothed_intensity_fused))
    monkeypatch.setattr(extractor, "orientation", counting("orientation", extractor.orientation))
    img = torch.from_numpy(bench_frames(1, 120, 160)[0])
    rng = np.random.default_rng(3)
    kps = KeyPoints.from_numpy(rng.uniform(20, 140, 30), rng.uniform(20, 100, 30),
                               rng.choice([12.0, 18.0], 30), device="cpu")
    want = {
        (True, False, "u8"): (1, 0, 0),
        (False, False, "u8"): (1, 0, 0),
        (True, True, "u8"): (0, 2, 0),
        (True, False, "u16"): (0, 0, 1),
    }
    for (rot, exact, kind), (n_rot, n_k2, n_orient) in want.items():
        for key in seen:
            seen[key] = 0
        ext = extractor.BriskExtractor(rotation_invariant=rot, angle_exact=exact, device="cpu")
        frame = img if kind == "u8" else img.to(torch.int32).mul(257).to(torch.uint16)
        ext(frame, kps)
        assert (seen["rotated"], seen["k2"], seen["orientation"]) == (n_rot, n_k2, n_orient), \
            (rot, exact, kind, seen)


@pytest.mark.parametrize("kind", ["v2", "v1", "ptn"])
def test_packed_tables_hold_the_pattern_pairs(kind, ptn_dir):
    """``pack_tables`` against the pattern's int64 index and int32 weight
    tables: (wdx, wdy) of each long pair, then each long and short pair as
    ``i | j << 16``, zero-padded to 16 bytes; cached on the pattern."""
    pat, _ = _patterns(kind, 1.0, ptn_dir)
    n_long, n_bits = pat.long_i.shape[0], pat.short_i.shape[0]
    packed = rotated.pack_tables(pat)
    assert packed.dtype == torch.int32 and packed.numel() == rotated.table_ints(n_long, n_bits)
    assert packed.numel() % 4 == 0 and packed.numel() - (3 * n_long + n_bits) < 4
    got = packed.numpy()
    w = got[:2 * n_long].reshape(n_long, 2)
    np.testing.assert_array_equal(w[:, 0], pat.long_wdx.numpy())
    np.testing.assert_array_equal(w[:, 1], pat.long_wdy.numpy())
    for block, (i, j) in ((got[2 * n_long:3 * n_long], (pat.long_i, pat.long_j)),
                          (got[3 * n_long:3 * n_long + n_bits], (pat.short_i, pat.short_j))):
        np.testing.assert_array_equal(block & 0xFFFF, i.numpy())
        np.testing.assert_array_equal(block >> 16, j.numpy())
    assert not got[3 * n_long + n_bits:].any()
    tables = pat.kernel_tables
    assert pat.kernel_tables is tables and torch.equal(tables.packed, packed)
    assert tables.args[-2:] == (n_long, n_bits) and pat.kernel_layout.p == pat.lut_x.shape[2]
    if kind == "v2":
        assert (n_long, n_bits, 4 * packed.numel()) == (856, 384, 11808)
    if kind == "v1":
        assert (n_long, n_bits, 4 * packed.numel()) == (870, 512, 12496)


def test_packed_tables_refuse_indices_past_int16():
    """A pattern with an index over 32767 (or outside its points) is
    refused when its tables are packed, before any launch."""
    import dataclasses

    from ethzasl_brisk_tpu_torch import _kernels

    pat = DevicePattern.from_host(tpat.brisk_v2_pattern())
    p = pat.lut_x.shape[2]
    _kernels.reset_launches()
    for name, bad in (("long_j", 40_000), ("short_i", 32_768), ("short_j", p), ("long_i", -1)):
        idx = getattr(pat, name).clone()
        idx[3] = bad
        broken = dataclasses.replace(pat, **{name: idx})
        with pytest.raises(ValueError, match=f"{name}: indices must lie in"):
            rotated.pack_tables(broken)
        with pytest.raises(ValueError, match="int16"):
            broken.kernel_tables
    assert not any(_kernels.LAUNCHES.values())


def test_extractor_builds_its_pattern_once():
    """``BriskExtractor.pattern`` is one ``DevicePattern`` for the buffers
    it holds, so the packed tables it caches are built once; a reassigned
    buffer gives a new one."""
    ext = extractor.BriskExtractor(device="cpu")
    pat = ext.pattern
    assert ext.pattern is pat and pat.kernel_tables is ext.pattern.kernel_tables
    ext.long_wdx = ext.long_wdx.clone()
    assert ext.pattern is not pat and ext.pattern.long_wdx is ext.long_wdx
    ext2 = ext.to("cpu")
    assert ext2.pattern.lut_x is ext2.lut_x
