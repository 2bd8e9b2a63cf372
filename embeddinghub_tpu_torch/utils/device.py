"""The device the port's entry points put a store on.

The port exists to run on the card, so every entry point (``FlatIndex``,
``EmbeddingHub``, ``Space``, ``Version``, ``load_version``, the offline
``Index``) takes ``device="cuda"`` unless the caller says otherwise; the
CPU runs only when asked for (``device="cpu"``, as the tests do).
"""

from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device on a host without
    CUDA is an error, never a quiet move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r}: CUDA is not available on this host; pass "
            f"device='cpu' to run on the CPU")
    return dev
