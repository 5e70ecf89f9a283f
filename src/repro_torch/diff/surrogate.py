"""Surrogate-gradient spike primitive (DESIGN.md §17).

The port of the reference package's ``diff/surrogate.py``.  The one
non-differentiable op of every threshold neuron model is the spike
Heaviside ``v >= v_th``.  :class:`SpikeSurrogate` wraps it in a
``torch.autograd.Function`` whose

* **forward** is the exact Heaviside the inference path computes -
  ``(x >= 0)`` in ``x``'s dtype, so that surrogate-mode trajectories are
  bitwise inference mode's; and
* **derivative** is a pseudo-derivative of the threshold distance
  ``x = v - v_th`` [mV]:

  - ``"st"`` / ``"st:<width>"``      - straight-through boxcar: 1 inside
    ``|x| <= width`` (default 1 mV), 0 outside;
  - ``"fast_sigmoid"`` / ``"fast_sigmoid:<beta>"`` - SuperSpike
    (Zenke & Ganguli 2018): ``beta / (1 + beta*|x|)**2`` (default 1).

The reference defines one linear tangent rule (``jax.custom_jvp``) and
lets JAX derive both modes from it.  Here the rule is written twice, as
``backward`` (``g * grad_fn(x)``) and ``jvp`` (``t * grad_fn(x)``), so that
reverse mode (``torch.autograd.grad``, ``torch.func.grad``/``jacrev``) and
forward mode (``torch.func.jacfwd``, ``torch.autograd.forward_ad``) both
see the surrogate.  The ``setup_context`` form with
``generate_vmap_rule = True`` is what ``torch.func`` needs.

Model steps compute their spike bool exactly as before (reset and
refractory bookkeeping stay keyed off the bool, so the reset is detached)
and emit the float spike of this primitive as the state's ``spike``; the
engine writes it into the delay ring, so a loss's gradient flows spike ->
ring -> synaptic sweep -> membrane across steps.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["get_surrogate", "available_surrogates", "spike_surrogate",
           "SpikeSurrogate", "DEFAULT_ST_WIDTH", "DEFAULT_FS_BETA"]

#: default straight-through window half-width [mV]
DEFAULT_ST_WIDTH = 1.0
#: default fast-sigmoid steepness [1/mV]
DEFAULT_FS_BETA = 1.0


class SpikeSurrogate(torch.autograd.Function):
    """Heaviside forward (exact, in ``x.dtype``), ``grad_fn`` derivative in
    both AD modes.  ``grad_fn`` is a function of ``x`` alone (not
    differentiated)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, grad_fn):
        return (x >= 0).to(x.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, grad_fn = inputs
        ctx.save_for_backward(x)
        ctx.save_for_forward(x)
        ctx.grad_fn = grad_fn

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return ctx.grad_fn(x).to(x.dtype) * g, None

    @staticmethod
    def jvp(ctx, t, _):
        (x,) = ctx.saved_tensors
        return ctx.grad_fn(x).to(x.dtype) * t


def spike_surrogate(x, grad_fn):
    """Heaviside forward (exact, in ``x.dtype``), ``grad_fn`` derivative."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, dtype=torch.float32)
    return SpikeSurrogate.apply(x, grad_fn)


def _st_grad(width, x):
    return (x.abs() <= width).to(x.dtype)


def _fs_grad(beta, x):
    return beta / torch.square(1.0 + beta * x.abs())


_FAMILIES = {
    "st": (_st_grad, DEFAULT_ST_WIDTH),
    "fast_sigmoid": (_fs_grad, DEFAULT_FS_BETA),
}


def available_surrogates() -> tuple[str, ...]:
    return tuple(sorted(_FAMILIES))


@functools.lru_cache(maxsize=None)
def get_surrogate(spec: str):
    """Resolve ``"st"`` / ``"st:<width>"`` / ``"fast_sigmoid[:beta]"`` into
    ``spike_fn(x) -> float``: exact Heaviside forward, surrogate
    derivative.  Cached per spec, so one config shares one callable."""
    name, _, arg = spec.partition(":")
    if name not in _FAMILIES:
        raise ValueError(
            f"unknown surrogate {spec!r}; available families: "
            f"{available_surrogates()} (parameterize like 'st:0.5' or "
            f"'fast_sigmoid:10')")
    grad_family, default = _FAMILIES[name]
    try:
        scale = float(arg) if arg else default
    except ValueError:
        raise ValueError(
            f"surrogate {spec!r}: parameter {arg!r} is not a float") from None
    if scale <= 0:
        raise ValueError(f"surrogate {spec!r}: parameter must be > 0")
    grad_fn = functools.partial(grad_family, scale)

    def spike_fn(x):
        return spike_surrogate(x, grad_fn)

    return spike_fn
