"""Device resolution shared by the port's entry points.

Every entry point that places tensors (``ShardGraph.to``,
``engine.init_state``, ``engine.run``, ``snn.make_param_table``) defaults
to the card.  Without one it raises instead of running on the CPU: a run
that silently fell back would report CPU numbers as the card's.  Tests and
CPU users pass ``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev
