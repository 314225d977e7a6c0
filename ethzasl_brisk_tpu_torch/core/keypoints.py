"""Fixed-capacity keypoint struct-of-arrays (port of ``core/keypoints.py``).

Every field has shape ``(..., capacity)``: ``(capacity,)`` for one frame,
``(B, capacity)`` for a batch. Invalid slots are masked by ``valid``.
Fields mirror cv::KeyPoint: x, y, size (diameter), angle (degrees, -1 =
unset), response (detector score) and octave.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class KeyPoints:
    x: torch.Tensor         # f32
    y: torch.Tensor         # f32
    size: torch.Tensor      # f32
    angle: torch.Tensor     # f32, degrees, -1 == unset
    response: torch.Tensor  # f32
    octave: torch.Tensor    # i32
    valid: torch.Tensor     # bool

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]

    def fields(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))

    def map(self, fn) -> "KeyPoints":
        """Apply ``fn`` to every field."""
        return KeyPoints(*(fn(a) for a in self.fields()))

    def count(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum(dim=-1, dtype=torch.int32)

    @staticmethod
    def concatenate(parts: list["KeyPoints"]) -> "KeyPoints":
        return KeyPoints(
            *(torch.cat(cols, dim=-1) for cols in zip(*(p.fields() for p in parts)))
        )

    def take(self, idx: torch.Tensor) -> "KeyPoints":
        """Gather every field at ``idx`` along the last axis."""
        return self.map(lambda a: torch.gather(a, -1, idx))

    def compact(self) -> "KeyPoints":
        """Move valid keypoints to the front (stable), keeping capacity."""
        order = torch.sort((~self.valid).to(torch.uint8), dim=-1, stable=True).indices
        return self.take(order)

    def top_k(self, k: int) -> "KeyPoints":
        """Keep the k highest-response valid keypoints (capacity -> k).

        Invalid slots score ``-inf``; ties go to the lower index, as
        ``jax.lax.top_k`` breaks them (a stable descending sort does the
        same; ``torch.topk`` documents no tie order).
        """
        score = torch.where(
            self.valid, self.response, torch.full_like(self.response, float("-inf"))
        )
        idx = torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :k]
        return self.take(idx)
