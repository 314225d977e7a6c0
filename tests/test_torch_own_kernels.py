"""The port's grouped segment sums and the camera grid's walk back, on the
CPU: what their kernels compute, from their plain versions.

* ``segment_sums``: the kernel's order of adds (a chain a (segment,
  component) in ascending observation order, over the work space of
  (item, segment, 32-component slice) units that ``csrc/segment_sum.cu``
  flattens) replayed in torch, bitwise equal to ``segment_sum_plain``
  item by item; the work space, decoded as the kernel decodes it, covers
  every output once; mixed devices or types are refused; a solve makes one
  grouped call a Gauss-Newton step.
* ``walk_angles_plain`` (``geometry/camera_aware.py``): bitwise the chain
  it replaced, on the radial-tangential and equidistant grids, and the
  JAX package's chain (``ethzasl_brisk_tpu/geometry/camera_aware.py``,
  ``:527-534`` and ``:560-565``) run op by op; the kernel's constants are
  the float32 scalars the torch chain multiplies by.
"""
import math
import pathlib
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.geometry import camera_aware as jca  # noqa: E402
from ethzasl_brisk_tpu_torch import BriskFeature  # noqa: E402
from ethzasl_brisk_tpu_torch import geometry as tgeo  # noqa: E402
from ethzasl_brisk_tpu_torch.ba import segment  # noqa: E402
from ethzasl_brisk_tpu_torch.ba import window as tw  # noqa: E402
from ethzasl_brisk_tpu_torch.core.atan2f import atan2f  # noqa: E402
from ethzasl_brisk_tpu_torch.core.sincosf import sincosf  # noqa: E402
from ethzasl_brisk_tpu_torch.geometry import camera_aware as tca  # noqa: E402

CSRC = pathlib.Path(tca.__file__).resolve().parents[1] / "csrc"


def _constant(source: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text()).group(1))


# ---------------------------------------------------------------- segment sums

def _items(rng, dtype, width, o=3000, n=40):
    """A ~600-row segment (index 5), an empty one (17), dropped indices
    below 0 and at n + 2, values of mixed magnitude, in ``width`` columns."""
    idx = rng.integers(-3, n, o)
    idx[rng.random(o) < 0.2] = 5
    idx[idx == 17] = 18
    idx[rng.random(o) < 0.02] = n + 2
    vals = rng.normal(0, 1, (o, width)) * 10.0 ** rng.integers(-6, 6, (o, width))
    return torch.from_numpy(vals).to(dtype), segment.segment_plan(torch.from_numpy(idx), n)


def _unit_chains(items):
    """The kernel's sums, unit by unit: each (item, segment, slice) adds
    its rows' slice in ascending observation order, from 0."""
    outs = [torch.zeros((p.n, *v.shape[1:]), dtype=v.dtype) for v, p in items]
    for (values, plan), out in zip(items, outs):
        flat_v, flat_o = values.reshape(values.shape[0], -1), out.view(plan.n, -1)
        width = flat_v.shape[1]
        for seg in range(plan.n):
            rows = plan.order[plan.offsets[seg]:plan.offsets[seg + 1]]
            for c0 in range(0, width, segment.SLICE):
                acc = torch.zeros(min(segment.SLICE, width - c0), dtype=values.dtype)
                for r in rows:
                    acc = acc + flat_v[r, c0:c0 + segment.SLICE]
                flat_o[seg, c0:c0 + segment.SLICE] = acc
    return outs


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("width", [1, 3, 6, 9, 18, 36])
def test_grouped_sums_equal_per_item_plain(dtype, width):
    """The kernel's chains over a call's items, and ``segment_sums`` on
    the CPU, bit for bit ``segment_sum_plain`` of each item."""
    rng = np.random.default_rng(width)
    items = [_items(rng, dtype, width), _items(rng, dtype, max(width // 3, 1), o=700, n=90)]
    assert int(items[0][1].offsets[6] - items[0][1].offsets[5]) > 550
    ref = [segment.segment_sum_plain(v, p) for v, p in items]
    for got in (_unit_chains(items), segment.segment_sums(items)):
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert torch.equal(segment.segment_sum(*items[1]), ref[1])


@pytest.mark.parametrize("shapes", [
    [(6, 36), (1500, 9), (6, 6), (1500, 3), (9000, 18)],   # a Gauss-Newton step
    [(144, 36), (12, 6)],                                   # the pose graph
    [(1, 1), (0, 9), (5, 300), (3, 33)],                    # empty items, wide rows
], ids=["gn-step", "pose-graph", "ragged"])
def test_work_space_covers_every_output_once(shapes):
    """The units of ``brisk_segment_sums``, decoded as the kernel decodes
    them (item by first unit, segment and slice, a lane a component),
    write every (item, segment, component) exactly once; the grid strides
    over them by warps."""
    slice_, max_items = _constant("segment_sum.cu", "kSlice"), _constant("segment_sum.cu", "kMaxItems")
    assert slice_ == segment.SLICE and max_items == segment.MAX_ITEMS
    slices = [-(-w // slice_) for _, w in shapes]
    first = np.cumsum([0] + [n * s for (n, _), s in zip(shapes, slices)])
    first = np.concatenate([first, np.full(max_items - len(shapes), first[-1])])
    hits = [np.zeros((n, w), np.int64) for n, w in shapes]
    for u in range(int(first[-1])):
        it = max(i for i in range(max_items) if u >= first[i])
        local = u - first[it]
        seg, sl = divmod(local, slices[it])
        c = sl * slice_ + np.arange(32)
        live = c < shapes[it][1]
        hits[it][seg, c[live]] += 1
    assert all((h == 1).all() for h in hits)


def test_segment_sums_refuses_mixed_devices_or_dtypes():
    """One device and one float type a call; the kernel's wrapper takes
    CUDA tensors only; no launch."""
    from ethzasl_brisk_tpu_torch import _kernels

    plan = segment.segment_plan(torch.tensor([0, 2, 1, 2]), 3)
    ones = torch.ones(4, 6)
    _kernels.reset_launches()
    assert segment.segment_sums([]) == []
    with pytest.raises(ValueError, match="one device and one dtype"):
        segment.segment_sums([(ones, plan), (ones.double(), plan)])
    with pytest.raises(ValueError, match="one device and one dtype"):
        segment.segment_sums([(ones, plan), (torch.ones(4, 6, device="meta"), plan)])
    with pytest.raises(ValueError, match="float32 or float64"):
        segment.segment_sums([(ones.int(), plan)])
    with pytest.raises(ValueError, match="one row an observation"):
        segment.segment_sums([(torch.ones(5, 6), plan)])
    with pytest.raises(ValueError, match="CUDA"):
        segment.segment_sums_cuda([(ones, plan)])
    meta_plan = segment.SegmentPlan(*(t.to("meta") for t in (plan.key, plan.order, plan.offsets)),
                                    plan.n)
    with pytest.raises(ValueError, match="CUDA"):
        segment.segment_sums([(torch.ones(4, 6, device="meta"), meta_plan)])
    assert _kernels.LAUNCHES["segment_sum"] == 0


def _window():
    """A small dense window: 4 keyframes, 30 points seen from each."""
    rng = np.random.default_rng(5)
    k, n_lm = 4, 30
    pts = rng.uniform([-2, -1, 4], [2, 1, 8], (n_lm, 3))
    kf, lm = np.repeat(np.arange(k), n_lm), np.tile(np.arange(n_lm), k)
    t = -np.stack([np.linspace(0, 0.6, k), np.zeros(k), np.zeros(k)], 1)
    x_c = pts[lm] + t[kf]
    uv = np.stack([400 * x_c[:, 0] / x_c[:, 2] + 320, 400 * x_c[:, 1] / x_c[:, 2] + 240], 1)
    return dict(r=np.tile(np.eye(3), (k, 1, 1)), t=t + rng.normal(0, 0.01, (k, 3)),
                points=pts + rng.normal(0, 0.05, pts.shape), kf_idx=kf, lm_idx=lm,
                uv=uv + rng.normal(0, 0.3, uv.shape), valid=np.ones(len(kf), bool),
                fu=np.asarray(400.0), fv=np.asarray(400.0), cu=np.asarray(320.0),
                cv=np.asarray(240.0))


def test_solve_makes_one_grouped_call_a_step(monkeypatch):
    """An LM solve of 5 iterations calls ``segment_sums`` once a
    Gauss-Newton step with its five sums (one launch a step on the card),
    and the trimmed solve's landmark statistic is one call of two, between
    its half-budget stage and its full-budget re-solve."""
    calls = []
    real = tw.segment_sums
    monkeypatch.setattr(tw, "segment_sums", lambda items: calls.append(len(items)) or real(items))
    p = tw.BaProblem.from_numpy(_window(), "cpu")
    tw.solve_window_ba_lm(p, iterations=5)
    assert calls == [5] * 5
    calls.clear()
    tw.solve_window_ba_trimmed(p, iterations=4)
    assert calls == [5, 5, 2, 5, 5, 5, 5]


# ---------------------------------------------------------------- walk back

def _old_walk_back(maps, vidx, ux, uy, kps_x, kps_y, size, angle):
    """The grid's angle back-transform as the port ran it before
    ``walk_angles`` (``detect_and_compute``, its last lines)."""
    a_rad = angle * (math.pi / 180.0)
    sin_a, cos_a = sincosf(a_rad)
    p2x = ux + size * cos_a
    p2y = uy + size * sin_a
    real2 = tca._bilerp_maps(maps, vidx, p2x, p2y)
    return atan2f(real2[..., 1] - kps_y, real2[..., 0] - kps_x) * tca.DEG_PER_RAD


def _old_extraction(maps, vidx, kps_x, kps_y, size, ux, uy, ex, ey):
    """``_extraction_angles``' tail as the port ran it before."""
    uv2 = tca._bilerp_maps(maps, vidx, kps_x + size * ex, kps_y + size * ey)
    return atan2f(uv2[..., 1] - uy, uv2[..., 0] - ux) * tca.DEG_PER_RAD


@pytest.fixture(scope="module", params=["radtan", "equidistant"])
def grid(request):
    cls, coef = {"radtan": ("RadialTangentialDistortion", (-0.25, 0.06, 0.0, 0.0)),
                 "equidistant": ("EquidistantDistortion", (-0.01, 0.005, -0.002, 0.001))}[
        request.param]
    cam = tgeo.PinholeCamera(130.0, 130.0, 80.0, 60.0, 160, 120, getattr(tgeo, cls)(*coef))
    feature = BriskFeature(octaves=0, uniformity_radius=0.0, absolute_threshold=35.0,
                           max_candidates=64, max_keypoints=64, device="cpu")
    return tca.CameraAwareFeatureGrid(cam, feature, margin=20, device="cpu")


def _walk_inputs(grid, k=4000, wild=True):
    """Keypoints over the image and its views, with ``wild`` lanes off the
    maps, NaN and huge, so the truncations and clamps are exercised."""
    rng = np.random.default_rng(9)
    f = np.float32
    kx, ky = rng.uniform(-10, 170, k).astype(f), rng.uniform(-10, 130, k).astype(f)
    ux, uy = rng.uniform(-20, 200, k).astype(f), rng.uniform(-20, 100, k).astype(f)
    size = rng.uniform(4, 60, k).astype(f)
    angle = rng.uniform(-1, 360, k).astype(f)
    e = rng.normal(0, 1, (k, 2)).astype(f)
    if wild:
        for a in (kx, ux, size, angle):
            a[rng.integers(0, k, 40)] = np.nan
            a[rng.integers(0, k, 40)] = f(3e9)
            a[rng.integers(0, k, 40)] = f(-3e9)
    vidx = rng.integers(0, grid.dist_maps.shape[0], k).astype(np.int32)
    t = {name: torch.from_numpy(a) for name, a in dict(
        kx=kx, ky=ky, ux=ux, uy=uy, size=size, angle=angle, vidx=vidx).items()}
    t["e"] = torch.from_numpy(e)
    return t


def _same_bits(a, b):
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_walk_angles_plain_is_the_chain_it_replaced(grid):
    """Both angle sites of the grid, bit for bit the torch chain they
    replaced, NaN and out-of-map lanes included; ``walk_angles`` on CPU
    tensors is the plain version."""
    t = _walk_inputs(grid)
    ux_uy = torch.stack([t["ux"], t["uy"]], -1)  # the grid passes strided columns
    back = tca.walk_angles_plain(grid.dist_maps, t["vidx"], ux_uy[:, 0], ux_uy[:, 1], t["size"],
                                 t["kx"], t["ky"], angle=t["angle"])
    _same_bits(back, _old_walk_back(grid.dist_maps, t["vidx"], t["ux"], t["uy"], t["kx"],
                                    t["ky"], t["size"], t["angle"]))
    ext = tca.walk_angles_plain(grid.undist_maps, t["vidx"], t["kx"], t["ky"], t["size"],
                                t["ux"], t["uy"], direction=(t["e"][:, 0], t["e"][:, 1]))
    _same_bits(ext, _old_extraction(grid.undist_maps, t["vidx"], t["kx"], t["ky"], t["size"],
                                    t["ux"], t["uy"], t["e"][:, 0], t["e"][:, 1]))
    _same_bits(tca.walk_angles(grid.dist_maps, t["vidx"], t["ux"], t["uy"], t["size"], t["kx"],
                               t["ky"], angle=t["angle"]), back)
    assert int(back.isnan().sum()) > 0 and int(back.isfinite().sum()) > 3000


def test_walk_angles_plain_matches_the_jax_chain(grid):
    """On keypoints inside the maps, the JAX grid's two angle chains
    (``jnp.cos``/``jnp.sin``, its ``_bilerp_maps``, ``jnp.arctan2``, op by
    op on the CPU) and the plain version agree bit for bit."""
    t = _walk_inputs(grid, wild=False)
    j = {name: jnp.asarray(v.numpy()) for name, v in t.items()}
    lookup = jca.CameraAwareFeatureGrid._bilerp_maps
    with jax.disable_jit():
        a_rad = j["angle"] * (jnp.pi / 180.0)
        real2 = lookup(None, jnp.asarray(grid.dist_maps.numpy()), j["vidx"],
                       j["ux"] + j["size"] * jnp.cos(a_rad), j["uy"] + j["size"] * jnp.sin(a_rad))
        back = jnp.arctan2(real2[..., 1] - j["ky"], real2[..., 0] - j["kx"]) * (180.0 / jnp.pi)
        uv2 = lookup(None, jnp.asarray(grid.undist_maps.numpy()), j["vidx"],
                     j["kx"] + j["size"] * j["e"][:, 0], j["ky"] + j["size"] * j["e"][:, 1])
        ext = jnp.arctan2(uv2[..., 1] - j["uy"], uv2[..., 0] - j["ux"]) * (180.0 / jnp.pi)
    got_back = tca.walk_angles_plain(grid.dist_maps, t["vidx"], t["ux"], t["uy"], t["size"],
                                     t["kx"], t["ky"], angle=t["angle"])
    got_ext = tca.walk_angles_plain(grid.undist_maps, t["vidx"], t["kx"], t["ky"], t["size"],
                                    t["ux"], t["uy"], direction=(t["e"][:, 0], t["e"][:, 1]))
    _same_bits(got_back, torch.from_numpy(np.array(back)))
    _same_bits(got_ext, torch.from_numpy(np.array(ext)))


def test_walk_angles_kernel_constants():
    """The kernel's float32 scalars are those the torch chain multiplies by
    (a float32 tensor times a Python float rounds the scalar to float32),
    and torch's CPU float -> int32 gives INT_MIN for NaN and out-of-range
    values, which the kernel's truncation reproduces."""
    src = (CSRC / "angle.cu").read_text()
    walk = src[src.index("__global__ void walk_angles_kernel"):]
    bits = [int(b, 16) for b in re.findall(r"f32\(0x([0-9a-f]+)u\)", walk)]
    want = [np.float32(math.pi / 180.0), np.float32(tca.DEG_PER_RAD)]
    assert bits == [int(np.array(w).view(np.uint32)) for w in want]
    x = torch.from_numpy(np.random.default_rng(1).uniform(-400, 400, 10_000).astype(np.float32))
    _same_bits(x * (math.pi / 180.0), x * torch.tensor(want[0]))
    odd = torch.tensor([float("nan"), 3e9, -3e9, 2147483520.0, -2147483648.0, -2.5, 2.5])
    assert odd.to(torch.int32).tolist() == [-2**31, -2**31, -2**31, 2147483520, -2**31, -2, 2]


def test_walk_angles_cuda_refuses_what_it_cannot_launch(grid):
    """The kernel's wrapper raises before any build on CPU tensors, without
    an angle or a direction, or with both."""
    from ethzasl_brisk_tpu_torch import _kernels

    t = _walk_inputs(grid, k=8, wild=False)
    args = (grid.dist_maps, t["vidx"], t["ux"], t["uy"], t["size"], t["kx"], t["ky"])
    _kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        tca.walk_angles_cuda(*args, angle=t["angle"])
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="an angle or a direction"):
        tca.walk_angles_cuda(*meta)
    with pytest.raises(ValueError, match="an angle or a direction"):
        tca.walk_angles_cuda(*meta, angle=t["angle"].to("meta"),
                             direction=(t["kx"].to("meta"), t["ky"].to("meta")))
    assert _kernels.LAUNCHES["walk_angles"] == 0
