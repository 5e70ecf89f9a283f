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

K7 ports ``src/repro/kernels/stdp_update.py::stdp_update_worklist``: the
same update on the ELL layout for the post blocks of the activity gate's
worklist only (``csrc/stdp_update_worklist.cu``), IN PLACE - the blocks off
the list keep their weights, and writing only the listed blocks spares the
full copy of the weights an out-of-place result would need.  Its twin is
:func:`stdp_update_worklist_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.synaptic_gather import listed_blocks

__all__ = ["stdp_update", "stdp_update_plain", "stdp_update_worklist",
           "stdp_update_worklist_plain"]


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
    _build.require_no_grad("stdp_update", weights, arrived, post_spike,
                           k_pre, k_post)
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


# --------------------------------------------------------------------------
# K7: the update over a worklist of post blocks, in place (activity gate)
# --------------------------------------------------------------------------

def stdp_update_worklist_plain(weights, pre_idx, post_rel, plastic, arrived,
                               worklist, n_active, post_spike, k_pre,
                               k_post, *, params, eb: int, pb: int):
    """Plain-torch twin of K7: :func:`stdp_update_plain`'s ELL update on
    the slots of the listed blocks (:func:`~repro_torch.kernels.
    synaptic_gather.listed_blocks`), written into ``weights`` in place;
    returns ``weights``."""
    nb = weights.shape[0] // eb
    live = listed_blocks(worklist, n_active, nb).repeat_interleave(eb)
    new = stdp_update_plain(weights, pre_idx, post_rel, plastic & live,
                            arrived, post_spike, k_pre, k_post,
                            params=params, eb=eb, pb=pb)
    return weights.copy_(new)


def _worklist_launcher():
    fn = _build.load("stdp_update_worklist").stdp_update_worklist_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                       + [ctypes.c_float] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def stdp_update_worklist(weights, pre_idx, post_rel, plastic, arrived,
                         worklist, n_active, post_spike, k_pre, k_post, *,
                         params, eb: int, pb: int):
    """pl-STDP over the post blocks of a worklist, IN PLACE.

    ``weights``/``pre_idx``/``post_rel``/``plastic``/``arrived`` are the
    resident ELL arrays flattened to (NB*EB,) slot order, f32/int32/int32/
    bool/f32, ``post_rel`` block-relative.  ``worklist`` (cap,) int32 and
    ``n_active`` (a () int32 tensor) come from the gate and are read on the
    device: the first ``n_active`` entries are walked, or every block when
    ``n_active > cap``; entries outside [0, NB) are padding, and the
    walked ids must be distinct (the gate's are ascending).  The listed
    blocks' plastic slots of ``weights`` are updated in place, every other
    slot is left untouched; returns ``weights``.  ``post_spike`` (n_local,)
    f32, traces ``k_pre`` (M,) and ``k_post`` (n_local,) f32; ``params`` is
    (lam, alpha, mu, w0, w_min, w_max).
    """
    _build.require_no_grad("stdp_update_worklist", weights, arrived,
                           post_spike, k_pre, k_post)
    if _build.dispatch_device(weights) == "cpu":
        return stdp_update_worklist_plain(
            weights, pre_idx, post_rel, plastic, arrived, worklist, n_active,
            post_spike, k_pre, k_post, params=params, eb=eb, pb=pb)
    dev = weights.device
    e = weights.shape[0]
    if (weights.dim() != 1 or e < 1 or eb < 1 or e % eb or pb < 1
            or e // eb > 65535):
        raise ValueError(f"bad geometry: weights {tuple(weights.shape)}, "
                         f"eb={eb}, pb={pb} (at most 65535 blocks)")
    nb = e // eb
    for name, x, dt in (("weights", weights, torch.float32),
                        ("pre_idx", pre_idx, torch.int32),
                        ("post_rel", post_rel, torch.int32),
                        ("plastic", plastic, torch.bool),
                        ("arrived", arrived, torch.float32)):
        _build.check_tensor(x, name, dt, (e,), dev)
    if worklist.dim() != 1:
        raise ValueError(f"worklist must be 1-D, got shape "
                         f"{tuple(worklist.shape)}")
    cap = worklist.shape[0]
    _build.check_tensor(worklist, "worklist", torch.int32, (cap,), dev)
    _build.check_tensor(n_active, "n_active", torch.int32, (), dev)
    n_local = k_post.shape[0]
    _build.check_tensor(post_spike, "post_spike", torch.float32, (n_local,),
                        dev)
    _build.check_tensor(k_post, "k_post", torch.float32, (n_local,), dev)
    _build.check_tensor(k_pre, "k_pre", torch.float32, (k_pre.shape[0],),
                        dev)
    if nb * pb < n_local:
        raise ValueError(f"{nb} blocks of pb={pb} rows cannot own "
                         f"{n_local} post neurons")

    c_dep, c_pot, mu, wmin, wmax = _coefficients(params)
    with torch.cuda.device(dev):
        err = _worklist_launcher()(
            weights.data_ptr(), pre_idx.data_ptr(), post_rel.data_ptr(),
            plastic.data_ptr(), arrived.data_ptr(), post_spike.data_ptr(),
            k_pre.data_ptr(), k_post.data_ptr(), worklist.data_ptr(),
            n_active.data_ptr(), nb, eb, pb, cap, c_dep, c_pot, mu, wmin,
            wmax, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "stdp_update_worklist")
    stdp_update_worklist.launches += 1
    return weights


#: kernel launches so far (plain-version calls do not count)
stdp_update_worklist.launches = 0
