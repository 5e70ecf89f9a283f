"""K1, the single edge pass of the hot path, and K6, its reduction half over
a worklist of post blocks - CUDA kernels and plain twins.

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

On the paths where the neuron update follows the edge pass, the kernel
also takes the update (:func:`synaptic_gather_update`): the warp that has
reduced a row adds the neuron's drive to its excitatory sum and takes the
neuron's LIF (K2), Izhikevich (K4) or AdEx (K5) step, from the same source
as the standalone kernels (``csrc/neuron_math.cuh``), so the result is
bitwise K1 -> add -> K2/K4/K5 and the sums never reach device memory.  Its
twin is :func:`synaptic_gather_update_plain`.

K6 ports ``src/repro/kernels/synaptic_gather.py::blocked_reduce_sweep``:
the activity gate (``"cuda:sparse"``) gathers the arrivals in a plain-torch
pre-pass, and :func:`blocked_reduce_sweep` (``csrc/blocked_reduce_sweep.cu``)
sums ``w * arrived`` per post row and channel over the blocks of a worklist
only, in K1's sum order, so that the gated sums equal K1's bitwise.  Its
twin is :func:`blocked_reduce_sweep_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import snn
from repro_torch.kernels import _build
from repro_torch.kernels import adex_step as adex_mod
from repro_torch.kernels import izhikevich_step as izh_mod
from repro_torch.kernels.lif_step import lif_step_plain

__all__ = ["synaptic_gather", "synaptic_gather_plain", "segment_bounds",
           "synaptic_gather_update", "synaptic_gather_update_plain",
           "blocked_reduce_sweep", "blocked_reduce_sweep_plain",
           "listed_blocks", "DEFAULT_PB", "NEURON_STATE"]

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
    i_ex, i_in = _row_sums(post_rel, weight, arrived, channel, pb)
    return i_ex, i_in, arrived


def _row_sums(post_rel, weight, arrived, channel, pb: int):
    """Per post row, the sums of ``weight * arrived`` over channel 0 and
    channel 1, one ``index_add_`` each: the twins of K1 and K6 share it, so
    on the CPU they give the same bits for the same arrivals."""
    nb = weight.shape[0]
    contrib = (weight * arrived).reshape(-1)
    post = (torch.arange(nb, device=weight.device)[:, None] * pb
            + post_rel).reshape(-1)
    ch = channel.reshape(-1)
    zero = torch.zeros((), dtype=contrib.dtype, device=contrib.device)
    out = lambda c: torch.zeros(nb * pb, dtype=contrib.dtype,
                                device=contrib.device).index_add_(
        0, post, torch.where(ch == c, contrib, zero))
    return out(0), out(1)


def _check_edges(pre_idx, post_rel, weight, delay, channel, ring, t,
                 max_delay: int, pb: int, fresh, bounds):
    """Validate K1's edge arguments for the card; returns ``bounds``,
    built here if not given."""
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
    return bounds


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
    _build.require_no_grad("synaptic_gather", weight, ring, fresh)
    if _build.dispatch_device(weight) == "cpu":
        return synaptic_gather_plain(pre_idx, post_rel, weight, delay,
                                     channel, ring, t, max_delay=max_delay,
                                     pb=pb, fresh=fresh)
    bounds = _check_edges(pre_idx, post_rel, weight, delay, channel, ring, t,
                          max_delay, pb, fresh, bounds)
    dev = weight.device
    nb, eb = weight.shape
    m = ring.shape[1]
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


# --------------------------------------------------------------------------
# K1 with the neuron update as its epilogue (K1 + K2, K1 + K4, K1 + K5)
# --------------------------------------------------------------------------

#: the neuron state each epilogue takes, in the order of the standalone
#: kernel's arguments (``lif_step``, ``izhikevich_step``, ``adex_step``),
#: and its table width
NEURON_STATE = {"lif": (("v", "syn_ex", "syn_in", "ref_count"), snn.NCOL),
                "izhikevich": (("v", "u", "syn_ex", "syn_in", "ref_count"),
                               izh_mod.NCOL),
                "adex": (("v", "w_ad", "syn_ex", "syn_in", "ref_count"),
                         adex_mod.NCOL)}
#: each two-variable epilogue's plain step (LIF's takes ``cond``)
_TWO_VARIABLE_PLAIN = {"izhikevich": izh_mod.izhikevich_step_plain,
                       "adex": adex_mod.adex_step_plain}


def _check_neuron(neuron: str, state, cond: bool) -> None:
    if neuron not in NEURON_STATE:
        raise ValueError(f"neuron must be one of {sorted(NEURON_STATE)}, "
                         f"got {neuron!r}")
    names = NEURON_STATE[neuron][0]
    if len(state) != len(names):
        raise ValueError(f"{neuron} state is {names}, got {len(state)} "
                         "arrays")
    if cond and neuron != "lif":
        raise ValueError("the conductance form (cond=True) is LIF's only")


def synaptic_gather_update_plain(pre_idx, post_rel, weight, delay, channel,
                                 ring, t, state, group_id, table, *,
                                 neuron: str, max_delay: int,
                                 pb: int = DEFAULT_PB, cond: bool = False,
                                 drive=None, fresh=None):
    """Plain-torch twin of the fused kernel: :func:`synaptic_gather_plain`
    (``fresh[pre]`` where ``delay == 1`` when ``fresh`` is given),
    the sums of the ``n_local`` rows plus ``drive``, then
    :func:`~repro_torch.kernels.lif_step.lif_step_plain`,
    :func:`~repro_torch.kernels.izhikevich_step.izhikevich_step_plain` or
    :func:`~repro_torch.kernels.adex_step.adex_step_plain`."""
    _check_neuron(neuron, state, cond)
    i_ex, i_in, arrived = synaptic_gather_plain(
        pre_idx, post_rel, weight, delay, channel, ring, t,
        max_delay=max_delay, pb=pb, fresh=fresh)
    n = state[0].shape[0]
    i_ex, i_in = i_ex[:n], i_in[:n]
    if drive is not None:
        i_ex = i_ex + drive
    if neuron == "lif":
        return arrived, lif_step_plain(*state, group_id, i_ex, i_in, table,
                                       cond=cond)
    return arrived, _TWO_VARIABLE_PLAIN[neuron](*state, group_id, i_ex, i_in,
                                                table)


def _update_launcher(neuron: str):
    fn = getattr(_build.load("synaptic_gather"),
                 f"synaptic_gather_{neuron}_launch")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        n_state = len(NEURON_STATE[neuron][0])
        fn.argtypes = ([p] * 8 + [i] * 5            # K1's arguments
                       + [p] * (n_state + 3)        # drive, state, gid, table
                       + [i] * (3 if neuron == "lif" else 2)
                       + [p] * (n_state + 1)        # new state, spike
                       + [p])                       # stream
        fn.restype = ctypes.c_int
    return fn


def synaptic_gather_update(pre_idx, post_rel, weight, delay, channel, ring,
                           t, state, group_id, table, *, neuron: str,
                           max_delay: int, pb: int = DEFAULT_PB,
                           cond: bool = False, drive=None, fresh=None,
                           bounds=None):
    """K1's edge pass with the neuron update as its epilogue: blocked edge
    arrays (NB, EB) and one step's neuron state -> ``(arrived, new)``.

    The edge arguments are :func:`synaptic_gather`'s, ``fresh`` among them
    (the distributed step's exchanged spikes, read where ``delay == 1``).
    ``neuron`` is ``"lif"`` (``cond`` picks the conductance form),
    ``"izhikevich"`` or ``"adex"``;
    ``state`` is that model's state in :data:`NEURON_STATE` order, each
    (n_local,) f32 except int32 ``ref_count``, with ``n_local <= NB*PB``
    (rows beyond it are the layout's padding and take no step);
    ``group_id`` (n_local,) int32; ``table`` (G, NCOL) f32, its rows
    contiguous but possibly further apart; ``drive`` (n_local,) f32 or None,
    added to the excitatory sum.  ``new`` is what ``lif_step``,
    ``izhikevich_step`` or ``adex_step`` returns for the same inputs: the
    new state and the spike.
    Group ids are not range-checked on the card (that would sync every
    step).
    """
    _build.require_no_grad("synaptic_gather_update", weight, ring, fresh,
                           *state, table, drive)
    if _build.dispatch_device(weight) == "cpu":
        return synaptic_gather_update_plain(
            pre_idx, post_rel, weight, delay, channel, ring, t, state,
            group_id, table, neuron=neuron, max_delay=max_delay, pb=pb,
            cond=cond, drive=drive, fresh=fresh)
    _check_neuron(neuron, state, cond)
    bounds = _check_edges(pre_idx, post_rel, weight, delay, channel, ring, t,
                          max_delay, pb, fresh, bounds)
    dev = weight.device
    nb, eb = weight.shape
    m = ring.shape[1]
    n = state[0].shape[0] if state[0].dim() == 1 else -1
    if n < 1 or n > nb * pb:
        raise ValueError(f"bad geometry: neuron state "
                         f"{tuple(state[0].shape)} for {nb * pb} rows")
    names, ncol = NEURON_STATE[neuron]
    for name, x in zip(names, state):
        _build.check_tensor(x, name, torch.int32 if name == "ref_count"
                            else torch.float32, (n,), dev)
    _build.check_tensor(group_id, "group_id", torch.int32, (n,), dev)
    if drive is not None:
        _build.check_tensor(drive, "drive", torch.float32, (n,), dev)
    stride = _build.check_table(table, ncol, dev)

    arrived = torch.empty((nb, eb), dtype=torch.float32, device=dev)
    new = [torch.empty(n, dtype=torch.int32 if name == "ref_count"
                       else torch.float32, device=dev) for name in names]
    spike = torch.empty(n, dtype=torch.bool, device=dev)
    extra = (stride, n, int(bool(cond))) if neuron == "lif" else (stride, n)
    with torch.cuda.device(dev):
        err = _update_launcher(neuron)(
            pre_idx.data_ptr(), weight.data_ptr(), channel.data_ptr(),
            bounds.data_ptr(), ring.data_ptr(), t.data_ptr(),
            None if fresh is None else fresh.data_ptr(),
            arrived.data_ptr(), nb, eb, pb, max_delay, m,
            None if drive is None else drive.data_ptr(),
            *(x.data_ptr() for x in state), group_id.data_ptr(),
            table.data_ptr(), *extra,
            *(x.data_ptr() for x in new), spike.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"synaptic_gather_update ({neuron})")
    synaptic_gather_update.launches += 1
    synaptic_gather_update.launches_by_neuron[neuron] += 1
    return arrived, (*new, spike)


#: kernel launches so far, in all and by epilogue (plain-version calls do
#: not count; neither counts in ``synaptic_gather.launches``)
synaptic_gather_update.launches = 0
synaptic_gather_update.launches_by_neuron = dict.fromkeys(NEURON_STATE, 0)


# --------------------------------------------------------------------------
# K6: the reduction half over a worklist of post blocks (activity gate)
# --------------------------------------------------------------------------

def listed_blocks(worklist, n_active, nb: int):
    """(NB,) bool: the blocks that K6 and K7 walk for a worklist.

    ``worklist`` (cap,) int32 lists block ids in its first ``n_active``
    entries (a () int32 tensor); when ``n_active > cap`` the gate saturated
    and every block is walked.  Entries outside [0, NB) are padding.
    """
    cap = worklist.shape[0]
    valid = ((torch.arange(cap, device=worklist.device) < n_active)
             & (worklist >= 0) & (worklist < nb))
    idx = torch.where(valid, worklist, nb).long()
    hit = torch.zeros(nb + 1, dtype=torch.bool, device=worklist.device)
    return hit.index_fill_(0, idx, True)[:nb] | (n_active > cap)


def blocked_reduce_sweep_plain(post_rel, weight, arrived, channel, *,
                               pb: int = DEFAULT_PB, worklist=None,
                               n_active=None):
    """Plain-torch twin of K6: ``(i_ex, i_in)`` each (NB*PB,), zero on the
    rows of blocks the list does not walk."""
    i_ex, i_in = _row_sums(post_rel, weight, arrived, channel, pb)
    if worklist is None:
        return i_ex, i_in
    row = listed_blocks(worklist, n_active, weight.shape[0]
                        ).repeat_interleave(pb)
    zero = torch.zeros((), dtype=i_ex.dtype, device=i_ex.device)
    return torch.where(row, i_ex, zero), torch.where(row, i_in, zero)


def _reduce_launcher():
    fn = _build.load("blocked_reduce_sweep").blocked_reduce_sweep_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def blocked_reduce_sweep(post_rel, delay, weight, arrived, channel, *,
                         max_delay: int, pb: int = DEFAULT_PB, worklist=None,
                         n_active=None, bounds=None):
    """Resident blocked arrays (NB, EB) and pre-gathered arrivals ->
    ``(i_ex, i_in)``, each (NB*PB,), summed over the listed blocks only.

    ``post_rel``/``delay``/``channel`` int32 and ``weight``/``arrived``
    f32, each (NB, EB), in the builder's slot order (``arrived`` 0 on
    padding).  ``worklist`` (cap,) int32 and ``n_active`` (a () int32
    tensor) come from the gate and are read on the device (see
    :func:`listed_blocks`); with neither, every block is summed.  Rows of
    unlisted blocks are +0.0.  ``bounds`` is :func:`segment_bounds` of the
    layout (built here if not given).
    """
    if (worklist is None) != (n_active is None):
        raise ValueError("give both worklist and n_active, or neither")
    _build.require_no_grad("blocked_reduce_sweep", weight, arrived)
    if _build.dispatch_device(weight) == "cpu":
        return blocked_reduce_sweep_plain(post_rel, weight, arrived, channel,
                                          pb=pb, worklist=worklist,
                                          n_active=n_active)
    dev = weight.device
    nb, eb = weight.shape if weight.dim() == 2 else (-1, -1)
    if nb < 1 or eb < 1 or pb < 1 or max_delay < 1:
        raise ValueError(f"bad geometry: weight {tuple(weight.shape)}, "
                         f"pb={pb}, max_delay={max_delay}")
    for name, x in (("post_rel", post_rel), ("delay", delay),
                    ("channel", channel)):
        _build.check_tensor(x, name, torch.int32, (nb, eb), dev)
    _build.check_tensor(weight, "weight", torch.float32, (nb, eb), dev)
    _build.check_tensor(arrived, "arrived", torch.float32, (nb, eb), dev)
    cap = 0
    if worklist is not None:
        if worklist.dim() != 1:
            raise ValueError(f"worklist must be 1-D, got shape "
                             f"{tuple(worklist.shape)}")
        cap = worklist.shape[0]
        _build.check_tensor(worklist, "worklist", torch.int32, (cap,), dev)
        _build.check_tensor(n_active, "n_active", torch.int32, (), dev)
    if bounds is None:
        bounds = segment_bounds(post_rel, delay, pb=pb, max_delay=max_delay)
    _build.check_tensor(bounds, "bounds", torch.int32,
                        (nb, max_delay * pb + 1), dev)

    # unlisted rows stay 0: one memset for both outputs, none when every
    # block is summed
    alloc = torch.empty if worklist is None else torch.zeros
    out = alloc((2, nb * pb), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _reduce_launcher()(
            weight.data_ptr(), arrived.data_ptr(), channel.data_ptr(),
            bounds.data_ptr(),
            None if worklist is None else worklist.data_ptr(),
            None if n_active is None else n_active.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(),
            nb, eb, pb, max_delay, cap,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "blocked_reduce_sweep")
    blocked_reduce_sweep.launches += 1
    return out[0], out[1]


#: kernel launches so far (plain-version calls do not count)
blocked_reduce_sweep.launches = 0
