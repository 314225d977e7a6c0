"""Port parity: the batched steps' adjacent-frame match, bit for bit.

``match_adjacent`` on CPU tensors runs ``match_adjacent_plain``, the plain
version of kernel ``hamming_argmin`` (``csrc/match.cu``, held against it on
the card in tests/test_torch_gpu.py and chip_smoke.py ``[match]``). Here it
is held against the JAX package's ``_match_adjacent`` (the AST step, all
``W * 32`` bits), against the Harris step's ``match_pair`` (its first 384
bits, sentinel 385, whatever W), both jitted as in the steps, and against
XOR + popcount (``hamming_distance_matrix_popcnt``) with a first-index
argmin in numpy.
The words come from numpy seeds (``tests/_match_cases.py``), with
duplicated rows (ties go to the lowest train index), invalid slots, a train
frame with no valid slot and invalid queries, which keep their real best
index.
"""
import pathlib
from typing import NamedTuple

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.match import matcher as jm  # noqa: E402
from ethzasl_brisk_tpu.parallel.frames import _match_adjacent  # noqa: E402
from ethzasl_brisk_tpu_torch.match import matcher as tm  # noqa: E402
from tests._match_cases import CASES, case as _case  # noqa: E402


class _Kps(NamedTuple):
    valid: jnp.ndarray


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _popcount_argmin(words, valid, n_bits):
    """XOR + popcount (the port's hamming_distance_matrix_popcnt) on each
    adjacent pair, the sentinel on invalid train slots, numpy's first-index
    argmin, the sentinel on invalid queries."""
    b, k, _ = words.shape
    nw, sentinel = n_bits // 32, n_bits + 1
    best = np.zeros((max(b - 1, 0), k), np.int32)
    dist = np.zeros((max(b - 1, 0), k), np.int32)
    for p in range(b - 1):
        d = tm.hamming_distance_matrix_popcnt(_t(words[p + 1, :, :nw]),
                                              _t(words[p, :, :nw])).numpy()
        d = np.where(valid[p][None, :], d, sentinel)
        best[p] = np.argmin(d, axis=1)
        dist[p] = np.where(valid[p + 1], d[np.arange(k), best[p]], sentinel)
    return best, dist


def _match_pair_384(words, valid):
    """The Harris step's match (``_pipeline_step``'s ``match_pair``,
    ethzasl_brisk_tpu/parallel/frames.py:256-265): the first 384 bits,
    sentinel 385, whatever W."""
    def match_pair(qd, td, qvd, tvd):
        d = jm.hamming_distance_matrix(qd, td)
        d = jnp.where(tvd[None, :], d, 385)
        return jnp.argmin(d, axis=1).astype(jnp.int32), jnp.where(qvd, jnp.min(d, axis=1), 385)

    w, v = jnp.asarray(words), jnp.asarray(valid)
    return jax.jit(jax.vmap(match_pair))(w[1:], w[:-1], v[1:], v[:-1])


@pytest.mark.parametrize("name", CASES)
def test_match_adjacent_plain_matches_jax_ast_step(name):
    """All W * 32 bits, sentinel W * 32 + 1: the AST step's match."""
    words, valid = _case(name)
    b, k, w = words.shape
    best, dist = tm.match_adjacent(_t(words), torch.from_numpy(valid), n_bits=w * 32)
    assert best.dtype == dist.dtype == torch.int32
    assert tuple(best.shape) == tuple(dist.shape) == (b - 1, k)
    if b > 1:
        jbest, jdist = jax.jit(_match_adjacent)(_Kps(jnp.asarray(valid)), jnp.asarray(words))
        np.testing.assert_array_equal(best.numpy(), np.asarray(jbest))
        np.testing.assert_array_equal(dist.numpy(), np.asarray(jdist))
    ref_best, ref_dist = _popcount_argmin(words, valid, w * 32)
    np.testing.assert_array_equal(best.numpy(), ref_best)
    np.testing.assert_array_equal(dist.numpy(), ref_dist)


@pytest.mark.parametrize("name", CASES)
def test_match_adjacent_plain_matches_jax_harris_step(name):
    """The first 384 bits, sentinel 385, whatever W: the Harris step's
    match_pair (v1's 16-word descriptors included)."""
    words, valid = _case(name)
    best, dist = tm.match_adjacent(_t(words), torch.from_numpy(valid))
    if words.shape[0] > 1:
        jbest, jdist = _match_pair_384(words, valid)
        np.testing.assert_array_equal(best.numpy(), np.asarray(jbest))
        np.testing.assert_array_equal(dist.numpy(), np.asarray(jdist))
    ref_best, ref_dist = _popcount_argmin(words, valid, 384)
    np.testing.assert_array_equal(best.numpy(), ref_best)
    np.testing.assert_array_equal(dist.numpy(), ref_dist)


def test_match_adjacent_edge_rules():
    """The rules the kernel must keep, spelled out: ties to the lowest
    train index, an all-invalid train frame gives index 0 and the sentinel,
    an invalid query keeps its real best index, B = 1 gives (0, K)."""
    words, valid = _case("ties")
    words[1, 7] = words[0, 30]
    words[0, 5] = words[0, 30]  # the same row at train slots 5 and 30
    valid[0, 5] = valid[0, 30] = True
    valid[1, 7] = False
    valid[2] = False            # pair 2's train frame has no valid slot
    best, dist = tm.match_adjacent(_t(words), torch.from_numpy(valid))
    assert int(best[0, 7]) == 5 and int(dist[0, 7]) == 385  # invalid query: real argmin
    all_valid = valid.copy()
    all_valid[1, 7] = True
    b2, d2 = tm.match_adjacent(_t(words), torch.from_numpy(all_valid))
    assert int(b2[0, 7]) == 5 and int(d2[0, 7]) == 0
    assert torch.equal(best[2], torch.zeros_like(best[2]))
    assert torch.equal(dist[2], torch.full_like(dist[2], 385))
    one_best, one_dist = tm.match_adjacent(_t(words[:1]), torch.from_numpy(valid[:1]))
    assert tuple(one_best.shape) == tuple(one_dist.shape) == (0, words.shape[1])


def test_match_adjacent_cuda_checks_its_arguments():
    """The kernel's wrapper refuses what csrc/match.cu does not take,
    before it needs a card; a CPU tensor is refused by name."""
    words, valid = _case("w16")
    d, v = _t(words), torch.from_numpy(valid)
    for bad in (384 + 16, 16 * 32 + 32, -32):
        with pytest.raises(ValueError, match="n_bits"):
            tm.match_adjacent_cuda(d, v, n_bits=bad)
    with pytest.raises(ValueError, match="bool valid"):
        tm.match_adjacent_cuda(d, v.to(torch.uint8))
    with pytest.raises(ValueError, match="int32 words"):
        tm.match_adjacent_cuda(d.to(torch.int64), v)
    with pytest.raises(ValueError, match="CUDA"):
        tm.match_adjacent_cuda(d, v)
    src = pathlib.Path(tm.__file__).resolve().parents[1] / "csrc" / "match.cu"
    assert f"constexpr int kMaxWords = {tm.MAX_MATCH_WORDS};" in src.read_text()
