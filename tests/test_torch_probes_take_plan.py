"""G1's plan (``probes/gather.py:take_plan``) for each of its 30 probe calls
at full size, from shapes alone, and C's 16-byte rule.

The plan picks which body of ``csrc/probe_gather.cu`` serves a call (R, a
staged column band; L, staged source rows; D, direct loads) and cuts its
grid; the kernels trust it. These tests pin the body each call gets, the
shared memory a block may take, that the cut covers every output element
exactly once (``_boxes`` mirrors the kernels' blockIdx arithmetic), that
no misaligned pointer or width reaches a 16-byte move, and that a plan the
kernels cannot take raises. Nothing here allocates a probe's tables:
``cases.take_geometry`` runs each maker on zero-strided draws.
"""
import dataclasses

import numpy as np
import pytest
import torch

from ethzasl_brisk_tpu_torch.probes import cases, gather

G1_CASES = [c for c in cases.CASES if cases.KERNELS[c.kernel].counter == "probe_take"]

# The body each full-size call gets, the fastest in device time on an H100
# (PERF.md §6): R, L, or D with 16-byte moves (D4) or one output a thread
# (D1).
BODY = {
    "2-pallas_rows": "D4", "3-pallas_lane": "D1", "4-sub_small": "D1", "5-sub_big": "R",
    "6-sub_u8": "D1", "8-sub_gather": "R", "9-sub_gather2": "R", "10-gather_big": "L",
    "11-lane_scaled(8)": "L", "11-lane_scaled(32)": "L", "12-f_sub": "D1",
    "13-f_sub_big": "D4", **{f"17-probe({c})": "D1" for c in "abcdefg"},
    **{f"18-taa1({c})": "D1" for c in "abcd"}, "18-taa1(e)": "D4", "19-wide": "L",
    "20-gather_big": "D4", "24-gather8": "D4", "25-gather_big(16384)": "D4",
    "25-gather_big(131072)": "L", "25-gather_big(524288)": "L",
}


def _kind(plan: gather.TakePlan) -> str:
    if plan.body == "direct":
        return "D4" if plan.vector else "D1"
    return {"rows": "R", "lanes": "L"}[plan.body]


def _id(case):
    return f"{case.site}-{case.name}"


def _boxes(plan: gather.TakePlan, g: gather.TakeGeometry):
    """The output each CTA of ``plan`` writes, as the kernels cut their
    grids: (shape of the output space, (grid, axes, 2) [start, stop) boxes).
    R: (block, index row, column); L: (copy, source row, column); D: flat."""
    u = np.arange(plan.grid, dtype=np.int64)
    if plan.body == "rows":
        bands, splits = g.w // gather.BAND, -(-g.r // plan.rows)
        j0, i0 = (u % bands) * gather.BAND, (u // bands % splits) * plan.rows
        b = u // bands // splits
        spans = [(b, b + 1), (i0, np.minimum(i0 + plan.rows, g.r)), (j0, j0 + gather.BAND)]
        return (g.b, g.r, g.w), np.stack([np.stack(s, 1) for s in spans], 1)
    if plan.body == "lanes":
        groups, copies = -(-g.s // plan.rows), g.r // g.s
        s0, c0 = (u % groups) * plan.rows, (u // groups) * plan.copies
        spans = [(c0, np.minimum(c0 + plan.copies, copies)),
                 (s0, np.minimum(s0 + plan.rows, g.s)), (0 * u, 0 * u + g.w)]
        return (copies, g.s, g.w), np.stack([np.stack(s, 1) for s in spans], 1)
    n, per = g.b * g.r * g.w, plan.threads * (4 if plan.vector else 1)
    return (n,), np.stack([u * per, np.minimum(u * per + per, n)], 1)[:, None, :]


def _assert_exact_cover(shape, boxes):
    """Every element of ``shape`` in exactly one box: count the boxes over
    the cells that all their edges cut the space into."""
    assert (boxes[..., 0] < boxes[..., 1]).all() and (boxes[..., 0] >= 0).all()
    assert (boxes[..., 1] <= np.array(shape)).all()
    edges = [np.union1d(np.unique(boxes[:, a, :]), [0, n]) for a, n in enumerate(shape)]
    count = np.zeros([len(e) - 1 for e in edges], np.int32)
    lo = [np.searchsorted(e, boxes[:, a, 0]) for a, e in enumerate(edges)]
    hi = [np.searchsorted(e, boxes[:, a, 1]) for a, e in enumerate(edges)]
    if all(((h - l) == 1).all() for l, h in zip(lo, hi)):  # one cell a box
        np.add.at(count, tuple(lo), 1)
    else:
        for box in zip(*lo, *hi):
            count[tuple(slice(box[a], box[a + len(shape)]) for a in range(len(shape)))] += 1
    assert (count == 1).all()


def test_thirty_g1_calls():
    assert len(G1_CASES) == 30
    assert [_id(c) for c in G1_CASES] == list(BODY)


@pytest.mark.parametrize("case", G1_CASES, ids=_id)
def test_full_size_plan(case):
    """The body the record call found fastest; shared memory within a
    block's; the cut covers each output element once."""
    g = cases.take_geometry(case)
    plan = gather.take_plan(g, 0, 0, 0)
    assert _kind(plan) == BODY[_id(case)], plan.label
    gather.check_take_plan(plan, g, 0, 0, 0)
    assert plan.smem <= gather.SMEM_LIMIT == 232_448
    _assert_exact_cover(*_boxes(plan, g))


@pytest.mark.parametrize("case", G1_CASES, ids=_id)
def test_geometry_from_shapes_matches_tensors(case):
    """``cases.take_geometry`` (shapes alone) equals the wrapper's own
    geometry of the case's real inputs, at the small scale."""
    g, _ = gather._take_geometry(*case.args(cases.tensors(case, False, "cpu")))
    assert cases.take_geometry(case, full=False) == g


@pytest.mark.parametrize("mods", [(4, 0, 0), (0, 8, 0), (0, 0, 12), (0, 4, 4)])
@pytest.mark.parametrize("case", G1_CASES, ids=_id)
def test_misaligned_pointer_gets_no_16_byte_move(case, mods):
    """A source off a 16-byte boundary leaves only D (which never moves the
    source 16 bytes at a time); an index or output off one, D one output a
    thread. Any width that is no multiple of 4 does the same."""
    g = cases.take_geometry(case)
    plan = gather.take_plan(g, *mods)
    assert plan.body == "direct"
    assert not (plan.vector and (mods[1] or mods[2] or g.w % 4))
    if mods[1] == mods[2] == 0:  # only the source is off: D may still move 16 bytes
        n = g.b * g.r * g.w
        assert plan == gather.direct_plan(g, g.w % 4 == 0 and n >= gather.FULL_CARD_OUTPUTS)
    gather.check_take_plan(plan, g, *mods)
    w = g.w + (g.w % 4 == 0)
    ragged = g._replace(w=w, ws=w if g.along_rows else g.ws)
    assert gather.take_plan(ragged, 0, 0, 0) == gather.direct_plan(ragged, False)


def _bad_plans():
    rows = cases.take_geometry(next(c for c in G1_CASES if c.name == "sub_big"))
    lanes = cases.take_geometry(next(c for c in G1_CASES if c.name == "wide"))
    r, l = gather.rows_plan(rows), gather.lanes_plan(lanes)
    d = gather.direct_plan(rows, True)
    return {
        "unknown body": (dataclasses.replace(d, body="tiles"), rows, (0, 0, 0)),
        "shared memory over a block's": (dataclasses.replace(r, smem=gather.SMEM_LIMIT + 16),
                                         rows, (0, 0, 0)),
        "R on a width no multiple of its band": (r, rows._replace(w=124, ws=124), (0, 0, 0)),
        "band too small for its memory": (dataclasses.replace(r, smem=r.smem - 16), rows,
                                          (0, 0, 0)),
        "R grid": (dataclasses.replace(r, grid=r.grid - 1), rows, (0, 0, 0)),
        "R misaligned source": (r, rows, (4, 0, 0)),
        "R on uint8": (r, rows._replace(src_bytes=1, out_bytes=1), (0, 0, 0)),
        "R on lanes": (gather.rows_plan(rows), lanes, (0, 0, 0)),
        "L on rows": (l, rows, (0, 0, 0)),
        "L rows beyond its memory": (dataclasses.replace(l, smem=l.smem - 16), lanes, (0, 0, 0)),
        "L grid": (dataclasses.replace(l, grid=l.grid + 1), lanes, (0, 0, 0)),
        "L misaligned index": (l, lanes, (0, 4, 0)),
        "D vector, misaligned output": (d, rows, (0, 0, 4)),
        "D vector, ragged width": (d, rows._replace(w=127, ws=127), (0, 0, 0)),
        "D grid short": (dataclasses.replace(d, grid=d.grid - 1), rows, (0, 0, 0)),
        "no threads": (dataclasses.replace(d, threads=0), rows, (0, 0, 0)),
        "block over 1024 threads": (dataclasses.replace(d, threads=2048), rows, (0, 0, 0)),
    }


@pytest.mark.parametrize("name", list(_bad_plans()))
def test_plan_the_kernels_cannot_take_raises(name):
    plan, g, mods = _bad_plans()[name]
    with pytest.raises(ValueError):
        gather.check_take_plan(plan, g, *mods)


def test_plans_fill_two_waves_on_smaller_cards():
    """R splits index rows and L splits copies to fill two waves of the
    card the call runs on; a card with fewer SMs gets fewer CTAs."""
    g = gather.TakeGeometry(1, 5000, 128, 2000, 128, 4, 4, True)
    for sms in (132, 16):
        plan = gather.rows_plan(g, sms=sms)
        assert plan.grid >= 2 * sms and -(-g.r // plan.rows) == plan.grid // 16
        _assert_exact_cover(*_boxes(plan, g))
    wide = cases.take_geometry(next(c for c in G1_CASES if c.name == "wide"))
    assert gather.lanes_plan(wide, sms=16).grid < gather.lanes_plan(wide, sms=132).grid


@pytest.mark.parametrize("transpose", [True, False])
@pytest.mark.parametrize("shape,mods,vector", [
    ((128, 4096), (0, 0), True), ((8192, 64), (0, 0), True), ((8192, 64), (4, 0), False),
    ((8192, 64), (0, 8), False), ((44, 76), (0, 0), True), ((45, 77), (0, 0), None),
    ((1, 33), (0, 0), None),
])
def test_relayout_vector_rule(shape, mods, vector, transpose):
    """C moves 16 bytes only from and to aligned bases; its transpose also
    needs whole 16-byte chunks in every source and output row, which the
    copy does not (it copies the last n % 4 words one by one)."""
    want = (not transpose) if vector is None else vector
    assert gather.relayout_vector(*shape, transpose, *mods) == want
    x = torch.arange(shape[0] * shape[1], dtype=torch.int32).view(shape)
    assert torch.equal(gather.relayout(x, transpose), x.T.contiguous() if transpose else x)
