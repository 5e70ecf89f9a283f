"""K3: pl-STDP weight update per synapse slot - CUDA kernel and plain twin.

Ports ``src/repro/kernels/stdp_update.py::stdp_update_kernel`` (the Pallas
TPU kernel):

    w1 = w - arrived * (lam*alpha) * w * K_post[post]
    w2 = clip(w1 + post_spike[post] * lam*w0^(1-mu)
              * exp(mu*log(max(w1, 1e-12))) * K_pre[pre], w_min, w_max)

on plastic slots; the others pass through.  Two layouts: flat
owner-sorted (``pb=0``, absolute post rows) and the post-block ELL layout
flattened to (NB*EB,) slot order (``pb>0``, block-relative post rows, the
owner of slot ``e`` being block ``e // eb``).

The kernel is ``csrc/stdp_update.cu`` (one thread per slot).  For CPU
tensors :func:`stdp_update` runs :func:`stdp_update_plain`; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["stdp_update", "stdp_update_plain"]


def _coefficients(params):
    """(c_dep, c_pot, mu, w_min, w_max) in double, as the Pallas kernel's
    Python floats are; they round to f32 when they meet a tensor."""
    lam, alpha, mu, w0, wmin, wmax = params
    return lam * alpha, lam * (w0 ** (1.0 - mu)), mu, wmin, wmax


def _owner_post(post_idx, e: int, eb: int, pb: int):
    if not pb:
        return post_idx.long()
    blk = torch.arange(e, device=post_idx.device) // eb
    return post_idx.long() + blk * pb


def stdp_update_plain(weights, pre_idx, post_idx, plastic, arrived,
                      post_spike, k_pre, k_post, *, params, eb: int,
                      pb: int = 0):
    """Plain-torch twin of the kernel, in the Pallas kernel's op order."""
    c_dep, c_pot, mu, wmin, wmax = _coefficients(params)
    post = _owner_post(post_idx, weights.shape[0], eb, pb)
    w1 = weights - arrived * c_dep * weights * k_post[post]
    w_safe = torch.clamp(w1, min=1e-12)
    pot = c_pot * torch.exp(mu * torch.log(w_safe)) * k_pre[pre_idx.long()]
    w2 = torch.clamp(w1 + post_spike[post] * pot, wmin, wmax)
    return torch.where(plastic, w2, weights)


def _launcher():
    fn = _build.load("stdp_update").stdp_update_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_float] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def stdp_update(weights, pre_idx, post_idx, plastic, arrived, post_spike,
                k_pre, k_post, *, params, eb: int, pb: int = 0):
    """``weights``/``pre_idx``/``post_idx``/``plastic``/``arrived`` (E,)
    f32/int32/int32/bool/f32 in one slot order (``E % eb == 0``);
    ``post_spike`` (n_local,) f32; traces ``k_pre`` (M,), ``k_post``
    (n_local,) f32.  ``params`` is (lam, alpha, mu, w0, w_min, w_max).
    Returns the new (E,) weights in the same order."""
    if _build.dispatch_device(weights) == "cpu":
        return stdp_update_plain(weights, pre_idx, post_idx, plastic,
                                 arrived, post_spike, k_pre, k_post,
                                 params=params, eb=eb, pb=pb)
    dev = weights.device
    e = weights.shape[0]
    if weights.dim() != 1 or e < 1 or eb < 1 or e % eb or pb < 0:
        raise ValueError(f"bad geometry: weights {tuple(weights.shape)}, "
                         f"eb={eb}, pb={pb}")
    for name, x, dt in (("weights", weights, torch.float32),
                        ("pre_idx", pre_idx, torch.int32),
                        ("post_idx", post_idx, torch.int32),
                        ("plastic", plastic, torch.bool),
                        ("arrived", arrived, torch.float32)):
        _build.check_tensor(x, name, dt, (e,), dev)
    n_local = k_post.shape[0]
    _build.check_tensor(post_spike, "post_spike", torch.float32, (n_local,),
                        dev)
    _build.check_tensor(k_post, "k_post", torch.float32, (n_local,), dev)
    _build.check_tensor(k_pre, "k_pre", torch.float32, (k_pre.shape[0],),
                        dev)
    if pb and (e // eb) * pb < n_local:
        raise ValueError(f"{e // eb} blocks of pb={pb} rows cannot own "
                         f"{n_local} post neurons")

    c_dep, c_pot, mu, wmin, wmax = _coefficients(params)
    out = torch.empty_like(weights)
    with torch.cuda.device(dev):
        err = _launcher()(
            weights.data_ptr(), pre_idx.data_ptr(), post_idx.data_ptr(),
            plastic.data_ptr(), arrived.data_ptr(), post_spike.data_ptr(),
            k_pre.data_ptr(), k_post.data_ptr(), out.data_ptr(),
            e, eb, pb, c_dep, c_pot, mu, wmin, wmax,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "stdp_update")
    stdp_update.launches += 1
    return out


#: kernel launches so far (plain-version calls do not count)
stdp_update.launches = 0
