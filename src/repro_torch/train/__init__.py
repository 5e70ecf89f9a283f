"""The training substrate the differentiable workloads use: the port of
the reference package's ``train/optimizer.py`` (AdamW, Adafactor, SGD,
clipping) and ``train/loop.py`` (the train step with gradient
accumulation).  ``train/grad_compress.py`` is not ported yet."""

from repro_torch.train import loop, optimizer

__all__ = ["loop", "optimizer"]
