"""Hamming distances between descriptor sets (port of ``match/matcher.py``).

Reference: ``BruteForceMatcher`` with the popcount-of-XOR distance
(hamming-inl.h:85-134). As in the JAX package, each 384-bit descriptor is
unpacked to a +-1 vector and ``hamming(q, t) = (n_bits - q . t) / 2``: one
float32 matrix product, exact because every partial sum is an integer of
magnitude <= 384 (and +-1 inputs are exact in TF32 too). A fused
XOR + popcount + argmin kernel is later work.
"""
from __future__ import annotations

import torch


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


def match_adjacent(desc: torch.Tensor, valid: torch.Tensor, n_bits: int = 384):
    """Match each frame's descriptors against the previous frame's.

    desc: (B, K, W) words, valid: (B, K). Returns (best index, distance),
    each (B-1, K) int32; invalid train slots and invalid queries get the
    sentinel distance n_bits + 1, and ties go to the lowest index.
    """
    sentinel = n_bits + 1
    d = hamming_distance_matrix(desc[1:], desc[:-1], n_bits)
    d = torch.where(valid[:-1, None, :], d, torch.full_like(d, sentinel))
    best = torch.argmin(d, dim=2)  # first index of the minimum
    bd = torch.gather(d, 2, best[..., None])[..., 0]
    bd = torch.where(valid[1:], bd, torch.full_like(bd, sentinel))
    return best.to(torch.int32), bd
