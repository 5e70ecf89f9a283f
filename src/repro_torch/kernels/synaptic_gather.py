"""K1: the single edge pass of the hot path - CUDA kernel and plain twin.

Ports ``src/repro/kernels/synaptic_gather.py::synaptic_gather`` (the Pallas
TPU kernel).  On the post-block ELL layout (NB blocks x EB slots, PB post
rows per block) it computes, for step ``t``:

* the arrival of every slot, ``ring[(t - delay) mod D, pre]`` - read from
  ``fresh[pre]`` instead where ``delay == 1`` and ``fresh`` (the spikes of
  step t-1 not yet in the ring, paper §III.C) is given - and 0 on padding
  slots (``delay == 0``);
* per post row, the sums of ``w * arrival`` over channel 0 (``i_ex``) and
  channel 1 (``i_in``).

The kernel (``csrc/synaptic_gather.cu``) gives one warp to each post row and
walks the row's per-delay runs through a table built once by
:func:`segment_bounds`; see the source for the design.  For CPU tensors
:func:`synaptic_gather` runs :func:`synaptic_gather_plain`, the same
function in plain torch; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["synaptic_gather", "synaptic_gather_plain", "segment_bounds",
           "DEFAULT_PB"]

DEFAULT_PB = 256


def segment_bounds(post_rel: torch.Tensor, delay: torch.Tensor, *,
                   pb: int, max_delay: int) -> torch.Tensor:
    """Per-(block, delay, row) run table of a blocked layout, for the kernel.

    The layout sorts each block's slots by (delay, post) with padding
    (``delay == 0``) at the tail, so the slots of row ``r`` at delay ``d``
    are ``[bounds[b, k], bounds[b, k + 1])`` with ``k = (d-1)*pb + r``, and
    ``bounds[b, max_delay*pb]`` is where the padding tail starts.  Returns
    (NB, max_delay*pb + 1) int32.  Built once per layout (it synchronises
    to validate the order); raises if the slots are not in that order.
    """
    nb, eb = post_rel.shape
    live = delay > 0
    pad_key = (max_delay + 1) * pb
    key = torch.where(live, delay * pb + post_rel,
                      torch.full_like(delay, pad_key))
    bad = (live & ((delay > max_delay) | (post_rel < 0) | (post_rel >= pb)))
    if bool(bad.any()):
        raise ValueError(f"blocked layout has delays above max_delay="
                         f"{max_delay} or post rows outside [0, {pb})")
    if eb > 1 and bool((key[:, 1:] < key[:, :-1]).any()):
        raise ValueError("blocked layout is not sorted by (delay, post) "
                         "within each block with padding at the tail")
    queries = torch.arange(pb, pad_key + 1, dtype=key.dtype,
                           device=key.device)
    return torch.searchsorted(key.contiguous(),
                              queries.expand(nb, -1).contiguous(),
                              out_int32=True)


def synaptic_gather_plain(pre_idx, post_rel, weight, delay, channel, ring, t,
                          *, max_delay: int, pb: int = DEFAULT_PB,
                          fresh=None):
    """Plain-torch twin of the kernel: ``(i_ex, i_in)`` each (NB*PB,) and the
    arrivals (NB, EB), with one ``index_add_`` per channel."""
    nb, eb = pre_idx.shape
    m = ring.shape[1]
    row = torch.remainder(t - delay, max_delay).long()
    arrived = ring.reshape(-1)[row * m + pre_idx.long()]
    if fresh is not None:
        arrived = torch.where(delay == 1, fresh[pre_idx.long()], arrived)
    arrived = arrived * (delay > 0)
    contrib = (weight * arrived).reshape(-1)
    post = (torch.arange(nb, device=pre_idx.device)[:, None] * pb
            + post_rel).reshape(-1)
    ch = channel.reshape(-1)
    zero = torch.zeros((), dtype=contrib.dtype, device=contrib.device)
    out = lambda c: torch.zeros(nb * pb, dtype=contrib.dtype,
                                device=contrib.device).index_add_(
        0, post, torch.where(ch == c, contrib, zero))
    return out(0), out(1), arrived


def _launcher():
    fn = _build.load("synaptic_gather").synaptic_gather_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def synaptic_gather(pre_idx, post_rel, weight, delay, channel, ring, t, *,
                    max_delay: int, pb: int = DEFAULT_PB, fresh=None,
                    bounds=None):
    """Blocked edge arrays (NB, EB) -> ``(i_ex, i_in, arrived)``.

    ``pre_idx``/``post_rel``/``delay``/``channel`` int32 and ``weight`` f32,
    each (NB, EB); ``ring`` (D, M) f32; ``t`` the step as an int32 tensor
    of one element (read on the device, so the step never syncs);
    ``fresh`` optional (M,) f32.  ``bounds`` is :func:`segment_bounds` of
    the layout: callers on the hot path pass the one they built at prepare
    time, else it is built here.
    """
    if _build.dispatch_device(weight) == "cpu":
        return synaptic_gather_plain(pre_idx, post_rel, weight, delay,
                                     channel, ring, t, max_delay=max_delay,
                                     pb=pb, fresh=fresh)
    dev = weight.device
    nb, eb = weight.shape if weight.dim() == 2 else (-1, -1)
    d, m = ring.shape
    if nb < 1 or eb < 1 or pb < 1 or d != max_delay:
        raise ValueError(f"bad geometry: weight {tuple(weight.shape)}, "
                         f"ring {tuple(ring.shape)}, pb={pb}, "
                         f"max_delay={max_delay}")
    for name, x in (("pre_idx", pre_idx), ("post_rel", post_rel),
                    ("delay", delay), ("channel", channel)):
        _build.check_tensor(x, name, torch.int32, (nb, eb), dev)
    _build.check_tensor(weight, "weight", torch.float32, (nb, eb), dev)
    _build.check_tensor(ring, "ring", torch.float32, (d, m), dev)
    _build.check_tensor(t, "t", torch.int32, tuple(t.shape), dev)
    if t.numel() != 1:
        raise ValueError(f"t must hold one step, got shape {tuple(t.shape)}")
    if fresh is not None:
        _build.check_tensor(fresh, "fresh", torch.float32, (m,), dev)
    if bounds is None:
        bounds = segment_bounds(post_rel, delay, pb=pb, max_delay=max_delay)
    _build.check_tensor(bounds, "bounds", torch.int32,
                        (nb, max_delay * pb + 1), dev)

    i_ex = torch.empty(nb * pb, dtype=torch.float32, device=dev)
    i_in = torch.empty(nb * pb, dtype=torch.float32, device=dev)
    arrived = torch.empty((nb, eb), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _launcher()(
            pre_idx.data_ptr(), weight.data_ptr(), channel.data_ptr(),
            bounds.data_ptr(), ring.data_ptr(), t.data_ptr(),
            None if fresh is None else fresh.data_ptr(),
            i_ex.data_ptr(), i_in.data_ptr(), arrived.data_ptr(),
            nb, eb, pb, max_delay, m,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "synaptic_gather")
    synaptic_gather.launches += 1
    return i_ex, i_in, arrived


#: kernel launches so far (plain-version calls do not count)
synaptic_gather.launches = 0
