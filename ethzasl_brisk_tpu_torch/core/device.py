"""Where the port's entry points run.

``BriskFeature``, ``BriskExtractor``, ``HarrisFeatureDetector`` and
``FramePipeline`` take a ``device`` argument whose default is ``"cuda"``:
they run on the card unless the caller asks for the CPU with
``device="cpu"``. Without a card, asking for one raises; nothing falls
back to the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """The torch device an entry point runs on: ``cuda`` (with its index
    filled in) or ``cpu``. Raises when a card is asked for and none exists."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"the port runs on 'cuda' or 'cpu', not {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)
