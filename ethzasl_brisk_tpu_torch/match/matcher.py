"""Hamming brute-force matching (port of ``match/matcher.py``).

Reference: ``BruteForceMatcher`` with the popcount-of-XOR distance
(hamming-inl.h:85-134): knnMatch keeps the k nearest train rows per query,
radiusMatch every row under a radius (brute-force-matcher.cc:95-214).

As in the JAX package, each 384-bit descriptor is unpacked to a +-1 vector
and ``hamming(q, t) = (n_bits - q . t) / 2``: one float32 matrix product,
exact because every partial sum is an integer of magnitude <= 384 (and +-1
inputs are exact in TF32 too). ``hamming_distance_matrix_popcnt`` is the
XOR + popcount form, kept for verification. The batched steps' match,
``match_adjacent``, is kernel ``hamming_argmin`` (``csrc/match.cu``) on the
card: XOR, popcount and the first index of the minimum, every pair of
frames in one launch, with no (K, K) matrix; ``match_adjacent_plain``, the
matmul route, is its plain version and serves CPU tensors. The other
matchers keep the matmul.

Descriptors are int32 words (the JAX package's uint32 words as bit
patterns). Ties: ``jax.lax.top_k`` sends them to the lower index, so the
k nearest come from a stable ascending sort of the distances (``torch.topk``
documents no tie order); ``torch.argmin`` returns the first minimum, as
``jnp.argmin`` does. Invalid or masked entries carry the sentinel distance
``n_bits + 1``.
"""
from __future__ import annotations

import numpy as np
import torch

from ethzasl_brisk_tpu_torch import _kernels

MAX_MATCH_WORDS = 32  # csrc/match.cu's kMaxWords: n_bits up to 1024


def unpack_bits_pm1(desc: torch.Tensor, n_bits: int) -> torch.Tensor:
    """(..., W) int32 words -> (..., n_bits) f32 in {+1, -1}, LSB first."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[..., :, None] >> shifts) & 1
    bits = bits.reshape(*desc.shape[:-1], desc.shape[-1] * 32)[..., :n_bits]
    return bits.to(torch.float32) * 2 - 1


def hamming_distance_matrix(
    query: torch.Tensor, train: torch.Tensor, n_bits: int = 384
) -> torch.Tensor:
    """(..., Q, W) x (..., T, W) words -> (..., Q, T) int32 distances."""
    q = unpack_bits_pm1(query, n_bits)
    t = unpack_bits_pm1(train, n_bits)
    dot = torch.matmul(q, t.transpose(-1, -2))
    return ((n_bits - dot) * 0.5).to(torch.int32)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit pattern (int64 holding 0 .. 2^32-1)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_distance_matrix_popcnt(query: torch.Tensor, train: torch.Tensor) -> torch.Tensor:
    """XOR + popcount distance matrix (reference semantics): (Q, T) int32."""
    x = (query[:, None, :] ^ train[None, :, :]).to(torch.int64) & 0xFFFFFFFF
    return _popcount32(x).sum(dim=-1, dtype=torch.int32)


def _smallest(d: torch.Tensor, k: int):
    """k smallest per row, ascending, ties to the lower index: (dist, idx)."""
    dist, idx = torch.sort(d, dim=-1, stable=True)
    return dist[..., :k], idx[..., :k].to(torch.int32)


def _sentinel_where(keep: torch.Tensor, d: torch.Tensor, n_bits: int) -> torch.Tensor:
    return torch.where(keep, d, torch.full_like(d, n_bits + 1))


def knn_match(query, train, query_valid, train_valid, k: int = 2, n_bits: int = 384):
    """k-nearest matches per query (commonKnnMatchImpl semantics).

    Returns (indices (Q, k) int32, distances (Q, k) int32); invalid train
    rows and invalid queries carry the sentinel distance.
    """
    d = _sentinel_where(train_valid[None, :], hamming_distance_matrix(query, train, n_bits), n_bits)
    dist, idx = _smallest(d, k)
    return idx, _sentinel_where(query_valid[:, None], dist, n_bits)


def radius_match_best(query, train, query_valid, train_valid, radius: int, n_bits: int = 384):
    """Best match per query if strictly below radius (test-match.cc:75-89).

    Returns (best_idx (Q,) int32, best_dist (Q,) int32, matched (Q,) bool).
    """
    d = _sentinel_where(train_valid[None, :], hamming_distance_matrix(query, train, n_bits), n_bits)
    best_idx = torch.argmin(d, dim=1)
    best_dist = torch.gather(d, 1, best_idx[:, None])[:, 0]
    return best_idx.to(torch.int32), best_dist, (best_dist < radius) & query_valid


def match_with_ratio_and_crosscheck(
    query, train, query_valid, train_valid, max_distance: int,
    ratio_num: int = 8, ratio_den: int = 10, n_bits: int = 384,
):
    """Lowe-style ratio test + mutual cross-check (for the VO front-end).

    Integer ratio test: d1 * ratio_den <= d2 * ratio_num. Returns
    (best_idx (Q,) int32, matched (Q,) bool).
    """
    d = hamming_distance_matrix(query, train, n_bits)
    d = _sentinel_where(train_valid[None, :] & query_valid[:, None], d, n_bits)
    dist, idx = _smallest(d, 2)
    d1, d2, best = dist[:, 0], dist[:, 1], idx[:, 0]
    reverse_best = torch.argmin(d, dim=0)  # best query per train row
    mutual = reverse_best[best.to(torch.int64)] == torch.arange(d.shape[0], device=d.device)
    matched = (
        query_valid & (d1 <= max_distance) & (d1 * ratio_den <= d2 * ratio_num) & mutual
    )
    return best, matched


def knn_match_masked(query, train, query_valid, train_valid, mask, k: int = 2,
                     n_bits: int = 384):
    """knnMatch with a (Q, T) pair mask, True allowing the pair
    (commonKnnMatchImpl mask support, brute-force-matcher.cc:101-137)."""
    d = hamming_distance_matrix(query, train, n_bits)
    d = _sentinel_where(mask & train_valid[None, :], d, n_bits)
    dist, idx = _smallest(d, k)
    return idx, _sentinel_where(query_valid[:, None], dist, n_bits)


def _in_radius(d, query_valid, radius, n_bits):
    """Distances under ``radius`` for valid queries, the sentinel elsewhere,
    and the true in-radius count per query."""
    d = _sentinel_where((d < radius) & query_valid[:, None], d, n_bits)
    return d, (d <= n_bits).sum(dim=1, dtype=torch.int32)


def radius_match_all(query, train, query_valid, train_valid, radius: int,
                     max_matches: int = 64, n_bits: int = 384):
    """Every match with distance < radius per query, distance-sorted (the
    reference's radiusMatch, commonRadiusMatchImpl, brute-force-matcher.cc:
    164-214), in a static per-query capacity.

    Returns (indices (Q, max_matches) int32, distances (Q, max_matches)
    int32, counts (Q,) int32); empty slots carry the sentinel distance.
    ``counts`` is the true in-radius count over the whole train set, so
    ``counts[q] > max_matches`` shows that the capacity truncated row q.
    """
    d = _sentinel_where(train_valid[None, :], hamming_distance_matrix(query, train, n_bits), n_bits)
    d, counts = _in_radius(d, query_valid, radius, n_bits)
    dist, idx = _smallest(d, max_matches)
    return idx, dist, counts


class DescriptorCollection:
    """Train-image collection (cv::DescriptorMatcher::add semantics).

    The reference's ``commonKnnMatchImpl`` scans a vector of train
    descriptor matrices with per-image masks and emits ``DMatch.imgIdx``
    (brute-force-matcher.cc:95-161). Here the collection is one
    concatenated train matrix plus two index tables, so a query costs one
    distance product; ties go to the lowest concatenated index, which is
    the reference's image-major, then row, scan order.
    """

    def __init__(self, trains=(), valids=None):
        self._trains: list[torch.Tensor] = []
        self._valids: list[torch.Tensor] = []
        for i, t in enumerate(trains):
            self.add(t, None if valids is None else valids[i])

    def add(self, train: torch.Tensor, valid: torch.Tensor | None = None):
        """Append one train image's (T_i, W) descriptors (+ valid mask)."""
        self._trains.append(train)
        self._valids.append(
            torch.ones(train.shape[0], dtype=torch.bool, device=train.device)
            if valid is None else valid
        )

    def clear(self):
        self._trains.clear()
        self._valids.clear()

    def __len__(self) -> int:
        return len(self._trains)

    @property
    def n_images(self) -> int:
        return len(self._trains)

    @property
    def sizes(self) -> list[int]:
        return [int(t.shape[0]) for t in self._trains]

    def stacked(self):
        """(train (T, W), valid (T,), img_idx (T,) int32, local_idx (T,) int32)."""
        sizes = self.sizes
        dev = self._trains[0].device
        img_idx = np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)
        local_idx = np.concatenate([np.arange(s, dtype=np.int32) for s in sizes])
        return (
            torch.cat(self._trains, dim=0),
            torch.cat(self._valids, dim=0),
            torch.from_numpy(img_idx).to(dev),
            torch.from_numpy(local_idx).to(dev),
        )

    def concat_masks(self, masks) -> torch.Tensor:
        """Per-image (Q, T_i) masks -> one (Q, T) concatenated mask."""
        return torch.cat(list(masks), dim=1)


def _collection_distances(query, collection, query_valid, masks, n_bits):
    train, train_valid, img_idx, local_idx = collection.stacked()
    if query_valid is None:
        query_valid = torch.ones(query.shape[0], dtype=torch.bool, device=query.device)
    keep = train_valid[None, :]
    if masks is not None:
        keep = keep & collection.concat_masks(masks)
    d = _sentinel_where(keep, hamming_distance_matrix(query, train, n_bits), n_bits)
    return d, query_valid, img_idx, local_idx


def _collection_indices(dist, gidx, img_idx, local_idx, n_bits):
    found = dist <= n_bits
    gidx = gidx.to(torch.int64)
    minus1 = torch.full_like(gidx, -1, dtype=torch.int32)
    return (
        torch.where(found, img_idx[gidx], minus1),
        torch.where(found, local_idx[gidx], minus1),
    )


def knn_match_collection(query, collection: DescriptorCollection, query_valid=None,
                         masks=None, k: int = 2, n_bits: int = 384):
    """knnMatch against a train collection (commonKnnMatchImpl,
    brute-force-matcher.cc:95-161).

    ``masks``: optional per-image list of (Q, T_i) bool tensors, True
    allowing the pair. Returns (img_idx (Q, k), train_idx (Q, k), dist
    (Q, k)), all int32; unfilled slots carry img_idx/train_idx -1 and the
    sentinel distance.
    """
    d, query_valid, img_idx, local_idx = _collection_distances(
        query, collection, query_valid, masks, n_bits
    )
    dist, gidx = _smallest(d, k)
    dist = _sentinel_where(query_valid[:, None], dist, n_bits)
    return (*_collection_indices(dist, gidx, img_idx, local_idx, n_bits), dist)


def radius_match_collection(query, collection: DescriptorCollection, radius: int,
                            query_valid=None, masks=None, max_matches: int = 64,
                            n_bits: int = 384):
    """radiusMatch against a train collection (commonRadiusMatchImpl,
    brute-force-matcher.cc:164-214) with imgIdx outputs and true counts
    (counts[q] > max_matches signals capacity truncation). Returns
    (img_idx, train_idx, dist), each (Q, max_matches), and counts (Q,)."""
    d, query_valid, img_idx, local_idx = _collection_distances(
        query, collection, query_valid, masks, n_bits
    )
    d, counts = _in_radius(d, query_valid, radius, n_bits)
    dist, gidx = _smallest(d, max_matches)
    return (*_collection_indices(dist, gidx, img_idx, local_idx, n_bits), dist, counts)


def match_adjacent_plain(desc: torch.Tensor, valid: torch.Tensor, n_bits: int = 384):
    """Plain version of ``match_adjacent``: the +-1 matmul distances over
    every (query, train) pair, ``torch.where``, ``argmin`` and ``gather``."""
    sentinel = n_bits + 1
    d = hamming_distance_matrix(desc[1:], desc[:-1], n_bits)
    d = torch.where(valid[:-1, None, :], d, torch.full_like(d, sentinel))
    best = torch.argmin(d, dim=2)  # first index of the minimum
    bd = torch.gather(d, 2, best[..., None])[..., 0]
    bd = torch.where(valid[1:], bd, torch.full_like(bd, sentinel))
    return best.to(torch.int32), bd


def _check_match_args(desc: torch.Tensor, valid: torch.Tensor, n_bits: int) -> int:
    if desc.dim() != 3 or desc.dtype != torch.int32:
        raise ValueError(f"match_adjacent: expected (B, K, W) int32 words, got {desc.dtype} "
                         f"{tuple(desc.shape)}")
    if valid.dtype != torch.bool or tuple(valid.shape) != tuple(desc.shape[:2]):
        raise ValueError(f"match_adjacent: expected a bool valid of {tuple(desc.shape[:2])}, "
                         f"got {valid.dtype} {tuple(valid.shape)}")
    if valid.device != desc.device:
        raise ValueError(f"match_adjacent: desc on {desc.device}, valid on {valid.device}")
    n_bits = int(n_bits)
    if n_bits < 0 or n_bits % 32 or n_bits // 32 > min(desc.shape[2], MAX_MATCH_WORDS):
        raise ValueError(f"match_adjacent: n_bits {n_bits} must be a multiple of 32 of at most "
                         f"{min(desc.shape[2], MAX_MATCH_WORDS)} words")
    return n_bits


def match_adjacent_cuda(desc: torch.Tensor, valid: torch.Tensor, n_bits: int = 384):
    """Kernel ``hamming_argmin``: every adjacent pair of a batch in one
    launch (none for B < 2 or K = 0). ``desc``: (B, K, W) int32 words and
    ``valid``: (B, K) bool on one card; ``n_bits`` a multiple of 32, at
    most W and 32 words."""
    n_bits = _check_match_args(desc, valid, n_bits)
    if desc.device.type != "cuda":
        raise ValueError(f"match_adjacent_cuda needs CUDA tensors, got {desc.device}")
    b, k, w = desc.shape
    out = torch.empty((2, max(b - 1, 0), k), dtype=torch.int32, device=desc.device)
    if b >= 2 and k > 0:
        desc, valid = desc.contiguous(), valid.contiguous()
        _kernels.launch("hamming_argmin", "hamming_argmin", desc.device, desc.data_ptr(),
                        valid.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), b, k, w, n_bits)
    return out[0], out[1]


def match_adjacent(desc: torch.Tensor, valid: torch.Tensor, n_bits: int = 384):
    """Match each frame's descriptors against the previous frame's.

    desc: (B, K, W) words, valid: (B, K). Returns (best index, distance),
    each (B-1, K) int32; invalid train slots and invalid queries get the
    sentinel distance n_bits + 1, ties go to the lowest index, and an
    invalid query keeps its real best index. Kernel ``hamming_argmin`` (one
    launch) for CUDA tensors, ``match_adjacent_plain`` for CPU tensors.
    """
    if desc.device.type == "cpu":
        return match_adjacent_plain(desc, valid, n_bits)
    return match_adjacent_cuda(desc, valid, n_bits)
