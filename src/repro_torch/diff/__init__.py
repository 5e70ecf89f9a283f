"""Differentiable simulation (DESIGN.md §17), the port of the reference
package's ``diff/``.

* :mod:`repro_torch.diff.surrogate` - the surrogate-gradient spike
  primitive (exact Heaviside forward, pseudo-derivative in both AD modes),
  selected per run by ``EngineConfig.surrogate``;
* :mod:`repro_torch.diff.rollout` - the gradient-safe engine rollout:
  chunks of steps under ``torch.utils.checkpoint``, each chunk's noise
  drawn before it, so that reverse-mode memory is bounded and a recomputed
  chunk replays the trajectory that ran;
* :mod:`repro_torch.diff.inverse` / :mod:`repro_torch.diff.classify` - the
  two workloads: brunel ``(g, eta)`` inversion from a target PSTH, and a
  surrogate-gradient SNN classifier on the :mod:`repro_torch.train`
  optimizer and loop.

Gradients run on the ``"flat"`` backend (plain torch); the ``"cuda"``
kernels refuse inputs that require grad.  ``surrogate`` is light (torch
only) so that :mod:`repro_torch.core` may import it; the other submodules
load lazily.
"""

from __future__ import annotations

import importlib

__all__ = ["surrogate", "rollout", "inverse", "classify"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"repro_torch.diff.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
