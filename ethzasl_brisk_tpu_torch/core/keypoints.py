"""Fixed-capacity keypoint struct-of-arrays (port of ``core/keypoints.py``).

Every field has shape ``(..., capacity)``: ``(capacity,)`` for one frame,
``(B, capacity)`` for a batch. Invalid slots are masked by ``valid``.
Fields mirror cv::KeyPoint: x, y, size (diameter), angle (degrees, -1 =
unset), response (detector score) and octave.

``from_numpy`` and ``empty`` build keypoints on ``device``, the card
unless the caller passes ``device="cpu"``, like every entry point;
``from_numpy`` is how a caller hands its own keypoints to ``compute``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ethzasl_brisk_tpu_torch.core.device import resolve_device

# Fill values of unset fields, as in the JAX package (cv::KeyPoint's
# defaults but size 12): padding slots and omitted columns take them.
_FILLS = dict(x=0.0, y=0.0, size=12.0, angle=-1.0, response=0.0, octave=0)


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
    def empty(capacity: int, device: str | torch.device = "cuda") -> "KeyPoints":
        """``capacity`` invalid slots: zeros, angle -1, octave 0."""
        dev = resolve_device(device)
        z = torch.zeros(capacity, dtype=torch.float32, device=dev)
        return KeyPoints(
            x=z, y=z.clone(), size=z.clone(),
            angle=torch.full((capacity,), -1.0, dtype=torch.float32, device=dev),
            response=z.clone(),
            octave=torch.zeros(capacity, dtype=torch.int32, device=dev),
            valid=torch.zeros(capacity, dtype=torch.bool, device=dev),
        )

    def to_numpy(self) -> dict:
        """Host numpy arrays of the valid entries only, keyed by field
        (``valid`` itself left out)."""
        mask = self.valid.cpu().numpy()
        return {
            f.name: getattr(self, f.name).cpu().numpy()[mask]
            for f in dataclasses.fields(self) if f.name != "valid"
        }

    @staticmethod
    def from_numpy(x, y, size=None, angle=None, response=None, octave=None,
                   capacity: int | None = None,
                   device: str | torch.device = "cuda") -> "KeyPoints":
        """Padded keypoints from host arrays of n points: the first
        min(n, capacity) slots valid (capacity defaults to n; longer input
        is truncated to it), omitted fields and padding at the fills
        (size 12, angle -1, octave 0, else 0)."""
        dev = resolve_device(device)
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        cap = capacity or n
        given = dict(x=x, y=y, size=size, angle=angle, response=response, octave=octave)

        def pad(name):
            dtype = np.int32 if name == "octave" else np.float32
            out = np.full((cap,), _FILLS[name], dtype)
            a = given[name]
            out[:n] = _FILLS[name] if a is None else np.asarray(a, dtype)[:cap]
            return torch.from_numpy(out).to(dev)

        return KeyPoints(
            **{name: pad(name) for name in _FILLS},
            valid=torch.from_numpy(np.arange(cap) < n).to(dev),
        )

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
