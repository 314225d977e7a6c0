"""Port parity: the gather probes' plain versions against the TPU probes.

Each of the sixteen ``pallas_call`` sites of P1 (``tools/bench_pallas_gather.py``)
and P3 (``tools/probes/probe_{sublane_gather,gather_formulations,sampler_blocks}.py``)
is declared again here with the probe's kernel body, BlockSpecs, memory
spaces and grid structure (the tools scripts keep them in closures inside
``main()``), at the small shapes of ``probes/cases.py``, and run with
``interpret=True`` on the CPU. The port's plain version must equal it bit
for bit. Site 2 is compared on the rows its grid writes; site 8 does not
trace in JAX and is held against site 9's result. The CUDA kernels are held
against these plain versions in tests/test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from ethzasl_brisk_tpu_torch import measure  # noqa: E402
from ethzasl_brisk_tpu_torch.probes import cases, gather  # noqa: E402

VMEM, SMEM, ANY = pltpu.VMEM, pltpu.SMEM, pl.ANY
P1_BLK = cases.P1_GEOMETRY[False]["blk"]


def _call(kernel, out_shape, *args, **kwargs):
    return np.asarray(pl.pallas_call(kernel, out_shape=out_shape, interpret=True, **kwargs)(*args))


# ---- P1: tools/bench_pallas_gather.py

def site1_pallas_2stage(x):
    tab, r, c = x["tab"], x["r"], x["c"]
    rows_t, m = tab.shape[0], r.shape[0]

    def k_2stage(tab_ref, r_ref, c_ref, out_ref):
        r = r_ref[:]
        c = c_ref[:]
        rows = jnp.take_along_axis(tab_ref[:], r[:, None] * jnp.ones((1, 128), jnp.int32), axis=0)
        vals = jnp.take_along_axis(rows, c[:, None], axis=1)
        out_ref[:] = vals[:, 0]

    return _call(
        k_2stage, jax.ShapeDtypeStruct((m,), jnp.int32), tab, r, c,
        grid=(m // P1_BLK,),
        in_specs=[
            pl.BlockSpec((rows_t, 128), lambda i: (0, 0), memory_space=VMEM),
            pl.BlockSpec((P1_BLK,), lambda i: (i,), memory_space=VMEM),
            pl.BlockSpec((P1_BLK,), lambda i: (i,), memory_space=VMEM),
        ],
        out_specs=pl.BlockSpec((P1_BLK,), lambda i: (i,), memory_space=VMEM),
    )


def site2_pallas_rows(x):
    tab, r2 = x["tab"], x["idx"]
    rows_t, m = tab.shape[0], r2.shape[0]

    def k_rows(tab_ref, r_ref, out_ref):
        out_ref[:] = jnp.take_along_axis(tab_ref[:], r_ref[:], axis=0)

    out = _call(
        k_rows, jax.ShapeDtypeStruct((m, 128), jnp.int32), tab, r2,
        grid=(m // P1_BLK,),
        in_specs=[
            pl.BlockSpec((rows_t, 128), lambda i: (0, 0), memory_space=VMEM),
            pl.BlockSpec((P1_BLK, 128), lambda i: (i, 0), memory_space=VMEM),
        ],
        out_specs=pl.BlockSpec((P1_BLK, 128), lambda i: (i, 0), memory_space=VMEM),
    )
    return out[: (m // P1_BLK) * P1_BLK]  # the rows the grid writes


def site3_pallas_lane(x):
    rows, c = x["src"], x["idx"]
    m = c.shape[0]

    def k_lane(rows_ref, c_ref, out_ref):
        out_ref[:] = jnp.take_along_axis(rows_ref[:], c_ref[:][:, None], axis=1)[:, 0]

    return _call(
        k_lane, jax.ShapeDtypeStruct((m,), jnp.int32), rows, c,
        grid=(m // P1_BLK,),
        in_specs=[
            pl.BlockSpec((P1_BLK, 128), lambda i: (i, 0), memory_space=VMEM),
            pl.BlockSpec((P1_BLK,), lambda i: (i,), memory_space=VMEM),
        ],
        out_specs=pl.BlockSpec((P1_BLK,), lambda i: (i,), memory_space=VMEM),
    )


# ---- P3: tools/probes/probe_sublane_gather.py

def _k_sub(s_ref, i_ref, o_ref):
    o_ref[:] = jnp.take_along_axis(s_ref[:], i_ref[:], axis=0)


def _sub_whole(x, dtype):
    src, idx = x["src"], x["idx"]
    return _call(
        _k_sub, jax.ShapeDtypeStruct(idx.shape, dtype), src, idx,
        in_specs=[pl.BlockSpec(memory_space=VMEM), pl.BlockSpec(memory_space=VMEM)],
        out_specs=pl.BlockSpec(memory_space=VMEM),
    )


def site4_sub_small(x):
    return _sub_whole(x, jnp.int32)


def site5_sub_big(x):
    src, idx, nblk = x["src"], x["idx"], x["blocks"]
    s2, j2 = src.shape[0] // nblk, idx.shape[0] // nblk
    return _call(
        _k_sub, jax.ShapeDtypeStruct((nblk * j2, 128), jnp.int32), src, idx,
        grid=(nblk,),
        in_specs=[
            pl.BlockSpec((s2, 128), lambda b: (b, 0), memory_space=VMEM),
            pl.BlockSpec((j2, 128), lambda b: (b, 0), memory_space=VMEM),
        ],
        out_specs=pl.BlockSpec((j2, 128), lambda b: (b, 0), memory_space=VMEM),
    )


def site6_sub_u8(x):
    return _sub_whole(x, jnp.uint8)


def site7_relay(x):
    pat = x["pat"]
    n, p, _ = pat.shape

    def k_relay(p_ref, o_ref):
        def body(k, _):
            o_ref[:, pl.ds(k, 1)] = p_ref[k].reshape(p * p, 1)
            return 0

        jax.lax.fori_loop(0, n, body, 0)

    return _call(
        k_relay, jax.ShapeDtypeStruct((p * p, n), jnp.int32), pat,
        in_specs=[pl.BlockSpec(memory_space=VMEM)],
        out_specs=pl.BlockSpec(memory_space=VMEM),
    )


# ---- P3: tools/probes/probe_gather_formulations.py

def _blocks3(x):
    nblk = x["blocks"]
    s = x["src"].reshape(nblk, -1, 128)
    i = x["idx"].reshape(nblk, -1, 128)
    return s, i, nblk, s.shape[1], i.shape[1]


def site8_sub_gather(x):
    s, i, nblk, s_rows, j = _blocks3(x)

    def k_sub(s_ref, i_ref, o_ref):
        o_ref[:] = jnp.take_along_axis(s_ref[:], i_ref[:], axis=0)

    return _call(
        k_sub, jax.ShapeDtypeStruct((nblk, j, 128), jnp.int32), s, i,
        grid=(nblk,),
        in_specs=[
            pl.BlockSpec((1, s_rows, 128), lambda b: (b, 0, 0), memory_space=VMEM),
            pl.BlockSpec((1, j, 128), lambda b: (b, 0, 0), memory_space=VMEM),
        ],
        out_specs=pl.BlockSpec((1, j, 128), lambda b: (b, 0, 0), memory_space=VMEM),
    )


def site9_sub_gather2(x):
    s, i, nblk, s_rows, j = _blocks3(x)

    def k_sub2(s_ref, i_ref, o_ref):
        o_ref[:] = jnp.take_along_axis(s_ref[0], i_ref[0], axis=0)[None]

    return _call(
        k_sub2, jax.ShapeDtypeStruct((nblk, j, 128), jnp.int32), s, i,
        grid=(nblk,),
        in_specs=[
            pl.BlockSpec((1, s_rows, 128), lambda b: (b, 0, 0), memory_space=VMEM),
            pl.BlockSpec((1, j, 128), lambda b: (b, 0, 0), memory_space=VMEM),
        ],
        out_specs=pl.BlockSpec((1, j, 128), lambda b: (b, 0, 0), memory_space=VMEM),
    )


def _lane_blocks(x, blk, memory_space):
    t, li = x["src"], x["idx"]
    m = t.shape[0]

    def k_g(t_ref, i_ref, o_ref):
        o_ref[:] = jnp.take_along_axis(t_ref[:], i_ref[:], axis=1)

    spec = (lambda: pl.BlockSpec((blk, 128), lambda k: (k, 0), memory_space=VMEM)) \
        if memory_space else (lambda: pl.BlockSpec((blk, 128), lambda k: (k, 0)))
    return _call(
        k_g, jax.ShapeDtypeStruct((m, 128), jnp.int32), t, li,
        grid=(m // blk,), in_specs=[spec(), spec()], out_specs=spec(),
    )


def site10_gather_big(x):
    # gather_big's (2048, 128) VMEM blocks, scaled to the small table.
    return _lane_blocks(x, 256, memory_space=True)


# ---- P3: tools/probes/probe_sampler_blocks.py

def site11_lane_scaled(x):
    # lane_scaled's (8192, 128) blocks with default memory space, scaled.
    return _lane_blocks(x, cases.BLOCK_ROWS[False], memory_space=False)


def site12_f_sub(x):
    src, idx = x["src"], x["idx"]
    return _call(_k_sub, jax.ShapeDtypeStruct(src.shape, jnp.int32), src, idx)


def site13_f_sub_big(x):
    src, idx, nblk = x["src"], x["idx"], x["blocks"]
    s, w = src.shape[0] // nblk, src.shape[1]
    return _call(
        _k_sub, jax.ShapeDtypeStruct((nblk * s, w), jnp.int32), src, idx,
        grid=(nblk,),
        in_specs=[pl.BlockSpec((s, w), lambda b: (b, 0)), pl.BlockSpec((s, w), lambda b: (b, 0))],
        out_specs=pl.BlockSpec((s, w), lambda b: (b, 0)),
    )


def site14_f_resh(x):
    pat = x["pat"]
    n, p, _ = pat.shape

    def k_resh(p_ref, o_ref):
        o_ref[:] = p_ref[:].reshape(n * p, p)

    return _call(k_resh, jax.ShapeDtypeStruct((n * p, p), jnp.int32), pat)


_DMA_SPECS = dict(
    in_specs=[pl.BlockSpec(memory_space=SMEM), pl.BlockSpec(memory_space=SMEM),
              pl.BlockSpec(memory_space=ANY)],
    out_specs=pl.BlockSpec(memory_space=VMEM),
)


def site15_f_dma(x):
    k_win = x["ax"].shape[0]

    def k_dma(ax_ref, ay_ref, img_ref, o_ref):
        def inner(sem):
            def body(k, _):
                dma = pltpu.make_async_copy(
                    img_ref.at[pl.ds(ay_ref[k], 64), pl.ds(ax_ref[k], 64)],
                    o_ref.at[pl.ds(k * 64, 64), :],
                    sem,
                )
                dma.start()
                dma.wait()
                return 0

            jax.lax.fori_loop(0, k_win, body, 0)

        pl.run_scoped(inner, sem=pltpu.SemaphoreType.DMA(()))

    return _call(k_dma, jax.ShapeDtypeStruct((k_win * 64, 64), jnp.int32),
                 x["ax"], x["ay"], x["img"], **_DMA_SPECS)


def site16_f_dma2(x):
    k_win, nsem = x["ax"].shape[0], 8

    def copy(ax_ref, ay_ref, img_ref, o_ref, sems, j):
        return pltpu.make_async_copy(
            img_ref.at[pl.ds(ay_ref[j], 64), pl.ds(ax_ref[j], 64)],
            o_ref.at[pl.ds(j * 64, 64), :],
            sems.at[j % nsem],
        )

    def k_dma2(ax_ref, ay_ref, img_ref, o_ref):
        def inner(sems):
            def body(k, _):
                copy(ax_ref, ay_ref, img_ref, o_ref, sems, k).start()

                @pl.when(k >= nsem - 1)
                def _():
                    copy(ax_ref, ay_ref, img_ref, o_ref, sems, k - (nsem - 1)).wait()

                return 0

            jax.lax.fori_loop(0, k_win, body, 0)

            def tail(t, _):
                copy(ax_ref, ay_ref, img_ref, o_ref, sems, k_win - (nsem - 1) + t).wait()
                return 0

            jax.lax.fori_loop(0, nsem - 1, tail, 0)

        pl.run_scoped(inner, sems=pltpu.SemaphoreType.DMA((nsem,)))

    return _call(k_dma2, jax.ShapeDtypeStruct((k_win * 64, 64), jnp.int32),
                 x["ax"], x["ay"], x["img"], **_DMA_SPECS)


JAX_SITES = {
    1: site1_pallas_2stage, 2: site2_pallas_rows, 3: site3_pallas_lane,
    4: site4_sub_small, 5: site5_sub_big, 6: site6_sub_u8, 7: site7_relay,
    8: site9_sub_gather2,  # site 8 does not trace: see test_site8_does_not_trace
    9: site9_sub_gather2, 10: site10_gather_big, 11: site11_lane_scaled,
    12: site12_f_sub, 13: site13_f_sub_big, 14: site14_f_resh,
    15: site15_f_dma, 16: site16_f_dma2,
}


def _inputs(case):
    x = case.make(np.random.default_rng(case.site), False)
    t = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in x.items()}
    return x, t


@pytest.mark.parametrize("case", cases.CASES_P13, ids=lambda c: f"{c.site}-{c.name}")
def test_plain_matches_jax_probe(case):
    x, t = _inputs(case)
    kern = cases.KERNELS[case.kernel]
    args = case.args(t)
    got = kern.plain(*args)
    assert torch.equal(kern.wrapper(*args), got)  # a CPU tensor takes the plain version
    want = JAX_SITES[case.site](x)
    assert got.numpy().dtype == want.dtype
    got = got.numpy().reshape(-1)[: want.size]  # site 2: the rows the grid writes
    np.testing.assert_array_equal(got, want.reshape(-1))
    assert want.size == got.size and want.size > 0


def test_site2_grid_leaves_tail_rows():
    """The TPU grid covers rows < (rows // blk) * blk only; the small shape
    keeps a tail, as the full one does (15616 rows, 14336 written)."""
    x, _ = _inputs(cases.CASES[1])
    m = x["idx"].shape[0]
    assert m % P1_BLK and m // P1_BLK >= 1
    full = cases.P1_GEOMETRY[True]
    n_round = (full["n"] // full["blk"]) * full["blk"]
    assert (n_round // 128, (n_round // 128 // 2048) * 2048) == (15616, 14336)


def test_site8_does_not_trace():
    """sub_gather's take_along_axis on (1, S, 128) blocks raises in JAX; the
    port serves its intended function, sub_gather2's (test above)."""
    case = next(c for c in cases.CASES if c.site == 8)
    x, _ = _inputs(case)
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        site8_sub_gather(x)


@pytest.mark.parametrize("case", [c for c in cases.CASES_P13 if c.kernel != "relayout"],
                         ids=lambda c: f"{c.site}-{c.name}")
def test_bytes_count_distinct_sectors(case):
    """The bound's traffic: the index and output arrays once, plus the
    distinct 32-byte sectors of the source that the call reads."""
    x, t = _inputs(case)
    kern = cases.KERNELS[case.kernel]
    out = kern.plain(*case.args(t))
    if case.kernel == "window_copy":
        r = np.arange(64)
        flat = (x["ay"][:, None, None] + r[:, None]) * x["img"].shape[1] + x["ax"][:, None, None] + r
        src, small = x["img"], 2 * x["ax"].nbytes
    elif case.kernel == "point_gather":
        flat = x["r"].astype(np.int64) * x["tab"].shape[1] + x["c"]
        src, small = x["tab"], x["r"].nbytes + x["c"].nbytes
    else:
        src, idx = x.get("src", x.get("tab")), x["idx"]
        if idx.ndim == 1:
            flat = np.arange(idx.shape[0]) * src.shape[1] + idx
        elif case.args(t)[2] == 1:
            flat = np.arange(idx.shape[0])[:, None] * src.shape[1] + idx
        else:
            nblk = x.get("blocks", 1)
            s, r = src.shape[0] // nblk, idx.shape[0] // nblk
            rows = (np.arange(idx.shape[0]) // r * s)[:, None] + idx
            flat = rows * src.shape[1] + np.arange(idx.shape[1])
        small = idx.nbytes
    sectors = np.unique(flat.astype(np.int64) * src.itemsize // measure.SECTOR).size
    assert kern.nbytes(*case.args(t)) == small + out.numel() * out.element_size() \
        + measure.SECTOR * sectors


def _bad_calls():
    i32 = torch.zeros((8, 4), dtype=torch.int32)
    idx = torch.zeros((8, 4), dtype=torch.int32)
    r1 = torch.zeros((5,), dtype=torch.int32)
    img = torch.zeros((70, 80), dtype=torch.int32)
    meta = torch.zeros((8, 4), dtype=torch.int32, device="meta")
    return {
        "take dtype": lambda: gather.take_along_axis(i32.double(), idx, 0),
        "take index dtype": lambda: gather.take_along_axis(i32, idx.long(), 0),
        "take shape": lambda: gather.take_along_axis(i32, idx[:, :3], 0),
        "take blocks": lambda: gather.take_along_axis(i32, idx[:6], 0, blocks=4),
        "take 1-D axis 0": lambda: gather.take_along_axis(i32, idx[:, 0].contiguous(), 0),
        "take strided": lambda: gather.take_along_axis(i32.T, idx.T, 1),
        "take device": lambda: gather.take_along_axis(i32, meta, 0),
        "take range": lambda: gather.take_along_axis(i32, idx + 8, 0),
        "point dtype": lambda: gather.point_gather(i32.to(torch.uint8), r1, r1),
        "point shape": lambda: gather.point_gather(i32, r1, r1[:4]),
        "point device": lambda: gather.point_gather(meta, r1, r1),
        "point range": lambda: gather.point_gather(i32, r1, r1 + 4),
        "relayout dtype": lambda: gather.relayout(i32.long(), True),
        "relayout shape": lambda: gather.relayout(i32[None], True),
        "relayout strided": lambda: gather.relayout(i32.T, False),
        "relayout device": lambda: gather.relayout(meta, False),
        "window dtype": lambda: gather.window_copy(img.float(), r1, r1),
        "window shape": lambda: gather.window_copy(img[:60], r1, r1),
        "window offsets": lambda: gather.window_copy(img, r1, r1[:4]),
        "window device": lambda: gather.window_copy(img, r1.to("meta"), r1),
        "window range": lambda: gather.window_copy(img, r1 + 17, r1),
    }


@pytest.mark.parametrize("name", list(_bad_calls()))
def test_wrappers_raise_on_bad_input(name):
    with pytest.raises(ValueError):
        _bad_calls()[name]()
