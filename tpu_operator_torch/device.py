"""Which device an entry point runs on.

Entry points run on ``cuda`` unless the caller asks for the CPU. Without a
GPU, a request for ``cuda`` (the default) raises; nothing falls back to the
CPU on its own.
"""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device: Optional[str] = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``, which
    raises when no GPU is visible."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "expected CUDA, found no GPU (pass device='cpu' to run the "
            "plain versions on the CPU)"
        )
    return dev


def available_device() -> str:
    """``cuda`` where a GPU is visible, else ``cpu``: the device a caller
    that accepts either (``--allow-cpu``) runs on."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def device_kind(dev: torch.device) -> str:
    """The card's name (``torch.cuda.get_device_name``), or ``cpu``."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
