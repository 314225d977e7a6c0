"""Port parity: the Mosaic probes P2's plain versions against the TPU probes.

Each of the 22 calls through the ten ``pallas_call`` sites of P2
(``tools/probes/probe_mosaic_gather{,2,3,4}.py``) is declared again here with
the probe's kernel body, BlockSpecs, memory spaces, grid and scratch shapes
(the scripts keep them in closures inside ``main()``), at the small shapes
of ``probes/cases.py``, and run with ``interpret=True`` on the CPU. The
port's plain version must equal it bit for bit, dtype included, and a CPU
tensor through the wrapper must give the same. The CUDA kernels are held
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
from ethzasl_brisk_tpu_torch.probes import cases, gather, mosaic  # noqa: E402

VMEM, SMEM, ANY = pltpu.VMEM, pltpu.SMEM, pl.ANY
# The lane gathers' (2048, 128) grid blocks (BLK of probe_mosaic_gather3.py
# and probe_mosaic_gather4.py), scaled to the small tables.
LANE_BLK = 128
SDS = jax.ShapeDtypeStruct


def _call(kernel, out_shape, *args, **kwargs):
    return np.asarray(pl.pallas_call(kernel, out_shape=out_shape, interpret=True, **kwargs)(*args))


def _whole(kernel, out_shape, *args):
    """The probe() helpers of probe_mosaic_gather{,2}.py: every operand and
    the output whole in VMEM, no grid."""
    return _call(kernel, out_shape, *args,
                 in_specs=[pl.BlockSpec(memory_space=VMEM) for _ in args],
                 out_specs=pl.BlockSpec(memory_space=VMEM))


# ---- probe_mosaic_gather.py:20 (probe, seven calls)

def site17_taa(axis):
    def run(x):
        return _whole(
            lambda t, i, o: o.__setitem__(slice(None), jnp.take_along_axis(t[:], i[:], axis=axis)),
            SDS(x["idx"].shape, x["src"].dtype), x["src"], x["idx"],
        )
    return run


def site17_one_hot(x):
    tabf, idx = x["src"], x["idx"]
    rows, lanes = tabf.shape
    return _whole(
        lambda t, i, o: o.__setitem__(
            slice(None),
            jax.lax.dot_general(
                (i[:, :1] == jax.lax.broadcasted_iota(jnp.int32, (rows, lanes), 1)
                 ).astype(jnp.float32) * t[:],
                jnp.ones((lanes, 1), jnp.float32),
                dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            ),
        ),
        SDS((rows, 1), jnp.float32), tabf, idx,
    )


# ---- probe_mosaic_gather2.py:25 (probe via taa1, five calls) and :106 (wide)

def taa1(t, i, o):
    o[:] = jnp.take_along_axis(t[:], i[:], axis=1)


def site18_taa1(x):
    return _whole(taa1, SDS(x["idx"].shape, x["src"].dtype), x["src"], x["idx"])


def site19_wide(x):
    t, i = x["src"], x["idx"]
    n, w = t.shape
    steps = i.shape[0] // n
    return _call(
        taa1, SDS((steps * n, 128), jnp.int32), t, i,
        grid=(steps,),
        in_specs=[
            pl.BlockSpec((n, w), lambda k: (0, 0), memory_space=VMEM),
            pl.BlockSpec((n, 128), lambda k: (k, 0), memory_space=VMEM),
        ],
        out_specs=pl.BlockSpec((n, 128), lambda k: (k, 0), memory_space=VMEM),
    )


# ---- probe_mosaic_gather3.py:61, :86, :107, :145, :173; probe_mosaic_gather4.py:35, :87

def k_g(t_ref, i_ref, o_ref):
    o_ref[:] = jnp.take_along_axis(t_ref[:], i_ref[:], axis=1)


def k_g8(t_ref, i_ref, o_ref):
    o_ref[:] = jnp.take_along_axis(t_ref[:].astype(jnp.int32), i_ref[:], axis=1)


def lane_blocks(kernel):
    """gather_big and gather8: (BLK, 128) blocks of table, index and output."""
    def run(x):
        t, i = x["src"], x["idx"]
        m = t.shape[0]

        def spec():
            return pl.BlockSpec((LANE_BLK, 128), lambda k: (k, 0), memory_space=VMEM)

        return _call(kernel, SDS((m, 128), jnp.int32), t, i,
                     grid=(m // LANE_BLK,), in_specs=[spec(), spec()], out_specs=spec())
    return run


def _square_blocks(kernel, *tables):
    m = tables[0].shape[0]
    spec = pl.BlockSpec((128, 128), lambda k: (k, 0), memory_space=VMEM)
    return _call(kernel, SDS((m, 128), jnp.int32), *tables,
                 grid=(m // 128,), in_specs=[spec] * len(tables), out_specs=spec)


def site21_transpose_many(x):
    def k_t(t_ref, o_ref):
        y = t_ref[:]
        for _ in range(8):
            y = y.T
            y = y + 1
        o_ref[:] = y

    return _square_blocks(k_t, x["t"])


def site22_chain(x):
    def k_gt(t_ref, i_ref, o_ref):
        a = jnp.take_along_axis(t_ref[:], i_ref[:], axis=1)  # (128,128)
        at = a.T
        o_ref[:] = jnp.take_along_axis(at, i_ref[:], axis=1)

    return _square_blocks(k_gt, x["t"], x["i"])


def dma_patches(per_step):
    """dma_patches: per grid step, ``per_step`` DMAs of a (96, 128) window at
    SMEM offsets into a VMEM scratch patch, each reduced over its rows."""
    def run(x):
        img, ax, ay = x["img"], x["ax"], x["ay"]
        n_kp = ax.shape[0]

        def k_dma(ax_ref, ay_ref, img_ref, o_ref, patch, sem):
            g = pl.program_id(0)
            for j in range(per_step):
                kk = g * per_step + j
                cp = pltpu.make_async_copy(
                    img_ref.at[pl.ds(ay_ref[kk], 96), pl.ds(ax_ref[kk], 128)], patch, sem
                )
                cp.start()
                cp.wait()
                o_ref[j, :] = jnp.sum(patch[:], axis=0)

        return _call(
            k_dma, SDS((n_kp, 128), jnp.int32), ax, ay, img,
            grid=(n_kp // per_step,),
            in_specs=[pl.BlockSpec(memory_space=SMEM), pl.BlockSpec(memory_space=SMEM),
                      pl.BlockSpec(memory_space=ANY)],
            out_specs=pl.BlockSpec((per_step, 128), lambda g: (g, 0), memory_space=VMEM),
            scratch_shapes=[pltpu.VMEM((96, 128), jnp.int32), pltpu.SemaphoreType.DMA],
        )
    return run


JAX_CALLS = {
    "probe(a)": site17_taa(0), "probe(b)": site17_taa(0), "probe(c)": site17_taa(0),
    "probe(d)": site17_taa(1), "probe(e)": site17_taa(1), "probe(f)": site17_taa(1),
    "probe(g)": site17_one_hot,
    **{f"taa1({c})": site18_taa1 for c in "abcde"},
    "wide": site19_wide,
    "gather_big": lane_blocks(k_g),
    "transpose_many": site21_transpose_many,
    "chain": site22_chain,
    "dma_patches@23": dma_patches(1),
    "gather8": lane_blocks(k_g8),
    **{f"gather_big({t[True][0]})": lane_blocks(k_g) for t in cases.SCALED25},
    "dma_patches@26": dma_patches(8),
}


def _jax_call(case):
    return JAX_CALLS.get(case.name) or JAX_CALLS[f"{case.name}@{case.site}"]


def _inputs(case):
    x = case.make(np.random.default_rng(case.site), False)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    return x, t


def _id(case):
    return f"{case.site}-{case.name}"


def test_every_p2_call_has_a_case():
    """22 calls over sites 17-26, each declared again above."""
    assert len(cases.CASES_P2) == 22
    assert sorted({c.site for c in cases.CASES_P2}) == list(range(17, 27))
    assert all(_jax_call(c) for c in cases.CASES_P2)


@pytest.mark.parametrize("case", cases.CASES_P2, ids=_id)
def test_plain_matches_jax_probe(case):
    x, t = _inputs(case)
    kern = cases.KERNELS[case.kernel]
    args = case.args(t)
    got = kern.plain(*args)
    wrapped = kern.wrapper(*args)  # a CPU tensor takes the plain version
    assert wrapped.dtype == got.dtype and torch.equal(wrapped, got)
    want = _jax_call(case)(x)
    assert got.numpy().dtype == want.dtype
    assert got.shape == want.shape and want.size > 0
    np.testing.assert_array_equal(got.numpy(), want)


def test_transpose_chain_is_t_plus_8():
    """Eight transposes return every element to its place; the adds wrap as
    int32 does, at the top of the range too."""
    t = torch.from_numpy(np.random.default_rng(21).integers(-2**31, 2**31, (256, 128),
                                                            dtype=np.int64).astype(np.int32))
    t[0, :4] = torch.tensor([2**31 - 1, 2**31 - 8, 2**31 - 9, -1], dtype=torch.int32)
    want = (t.to(torch.int64) + 8 + 2**31) % 2**32 - 2**31
    got = mosaic.transpose_chain_plain(t)
    assert got.dtype == torch.int32 and torch.equal(got.to(torch.int64), want)
    assert torch.equal(mosaic.transpose_chain(t), got)


@pytest.mark.parametrize("rounds", [1, 3])
def test_transpose_chain_odd_rounds_transpose(rounds):
    """An odd count of rounds leaves each 128 x 128 block transposed:
    ``x.T + rounds`` per block, so the count tests the data movement."""
    t = torch.from_numpy(np.random.default_rng(22).integers(-2**31, 2**31, (384, 128),
                                                            dtype=np.int64).astype(np.int32))
    got = mosaic.transpose_chain_plain(t, rounds=rounds)
    want = torch.cat([blk.T + rounds for blk in t.split(128)])
    assert torch.equal(got, want)
    assert torch.equal(mosaic.transpose_chain(t, rounds), got)
    assert mosaic.transpose_chain_ops(t, rounds) == rounds * t.numel()
    for bad in (0, -1, 2.5):
        with pytest.raises(ValueError, match="rounds"):
            mosaic.transpose_chain(t, bad)


def _sectors(flat, itemsize):
    return measure.SECTOR * np.unique(np.asarray(flat, np.int64) * itemsize // measure.SECTOR).size


@pytest.mark.parametrize("case", cases.CASES_P2, ids=_id)
def test_bytes_count_distinct_sectors(case):
    """The bound's traffic: the index and output arrays once, plus the
    distinct 32-byte sectors of the source that the call reads (T: its
    table read and written once)."""
    x, t = _inputs(case)
    kern = cases.KERNELS[case.kernel]
    args = case.args(t)
    out = kern.plain(*args)
    out_bytes = out.numel() * out.element_size()
    if case.kernel == "transpose_chain":
        want = 2 * x["t"].nbytes
    elif case.kernel == "gather_chain":
        i = x["i"].astype(np.int64)
        rows = np.arange(i.shape[0])
        first = rows - rows % 128
        k = first[:, None] + i
        m = i[k, (rows % 128)[:, None]]
        want = i.size * 4 + out_bytes + _sectors(k * 128 + m, 4)
    elif case.kernel == "window_colsum":
        img, ax, ay = x["img"], x["ax"], x["ay"]
        rows = ay[:, None, None] + np.arange(96)[:, None]
        flat = rows * img.shape[1] + ax[:, None, None] + np.arange(128)
        want = ax.nbytes + ay.nbytes + out_bytes + _sectors(flat, 4)
    else:
        src, idx = x["src"], args[1].numpy()
        if args[2] == 0:
            flat = idx * src.shape[1] + np.arange(idx.shape[1])
        else:
            flat = (np.arange(idx.shape[0]) % src.shape[0])[:, None] * src.shape[1] + idx
        want = idx.nbytes + out_bytes + _sectors(flat, src.itemsize)
    assert kern.nbytes(*args) == want


def test_window_colsum_ops():
    """S's operation count: 95 adds for each of 128 sums per window."""
    case = next(c for c in cases.CASES_P2 if c.kernel == "window_colsum")
    _, t = _inputs(case)
    assert mosaic.window_colsum_ops(*case.args(t)) == 95 * 128 * t["ax"].numel()


def _bad_calls():
    t = torch.zeros((256, 128), dtype=torch.int32)
    img = torch.zeros((100, 130), dtype=torch.int32)
    k1 = torch.zeros((3,), dtype=torch.int32)
    src = torch.zeros((8, 4), dtype=torch.int32)
    idx = torch.zeros((8, 4), dtype=torch.int32)
    return {
        "transpose dtype": lambda: mosaic.transpose_chain(t.float()),
        "transpose rows": lambda: mosaic.transpose_chain(t[:200]),
        "transpose width": lambda: mosaic.transpose_chain(t[:, :64].contiguous()),
        "transpose strided": lambda: mosaic.transpose_chain(t.view(128, 256).T),
        "transpose device": lambda: mosaic.transpose_chain(t.to("meta")),
        "chain shapes": lambda: mosaic.gather_chain(t, t[:128]),
        "chain index dtype": lambda: mosaic.gather_chain(t, t.long()),
        "chain range": lambda: mosaic.gather_chain(t, t + 128),
        "colsum dtype": lambda: mosaic.window_colsum(img.to(torch.uint8), k1, k1),
        "colsum image": lambda: mosaic.window_colsum(img[:95], k1, k1),
        "colsum offsets": lambda: mosaic.window_colsum(img, k1, k1[:2]),
        "colsum range": lambda: mosaic.window_colsum(img, k1 + 3, k1),
        "take out dtype": lambda: gather.take_along_axis(src, idx, 1, out_dtype=torch.uint8),
        "take widen float": lambda: gather.take_along_axis(src.float(), idx, 1,
                                                           out_dtype=torch.int32),
        "take shared rows": lambda: gather.take_along_axis(src, idx.repeat(2, 1)[:12], 1),
        "lane select dtype": lambda: gather.lane_select_plain(src, idx[:, :1].contiguous()),
        "lane select columns": lambda: gather.lane_select_plain(src.float(), idx),
    }


@pytest.mark.parametrize("name", list(_bad_calls()))
def test_wrappers_raise_on_bad_input(name):
    with pytest.raises(ValueError):
        _bad_calls()[name]()
