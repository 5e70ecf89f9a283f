"""The training substrate the differentiable workloads use: the port of
the reference package's ``train/optimizer.py`` (AdamW, Adafactor, SGD,
clipping) and ``train/loop.py`` (the train step with gradient
accumulation) and ``train/grad_compress.py`` (the int8 error-feedback
reduce over the ``"pod"`` axis)."""

from repro_torch.train import grad_compress, loop, optimizer

__all__ = ["grad_compress", "loop", "optimizer"]
