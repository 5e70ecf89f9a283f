"""Port kernels K1-K3: each plain twin against the reference's Pallas kernel.

The reference kernels run with ``interpret=True``, as ``tests/test_kernels.py``
runs them on the CPU; the port's wrappers run their plain-torch twins
because the tensors lie on the CPU.  Inputs are made with numpy from a seed
and handed to both.  The CUDA kernels themselves need the card:
``tests/test_torch_gpu.py`` holds each against its twin there.
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.lif_step import lif_step_kernel as ref_lif_step
from repro.kernels.stdp_update import stdp_update_kernel as ref_stdp_update
from repro.kernels.synaptic_gather import synaptic_gather as ref_gather
from repro.core import snn as ref_snn
from repro_torch.core import snn
from repro_torch.kernels import _build
from repro_torch.kernels import lif_step as lif_mod
from repro_torch.kernels import stdp_update as stdp_mod
from repro_torch.kernels import synaptic_gather as gather_mod

STDP_PARAMS = (0.1, 0.0513, 0.4, 45.61, 0.0, 200.0)


def sorted_blocked(rng, nb, eb, pb, m, d_max):
    """Random blocked ELL arrays in the builder's slot order: each block's
    live slots sorted by (delay, post), padding (delay 0) at the tail."""
    pre = np.zeros((nb, eb), np.int32)
    post = np.zeros((nb, eb), np.int32)
    delay = np.zeros((nb, eb), np.int32)
    for b in range(nb):
        live = int(rng.integers(eb // 2, eb + 1))
        d = rng.integers(1, d_max + 1, live)
        p = rng.integers(0, pb, live)
        order = np.lexsort((p, d))
        delay[b, :live], post[b, :live] = d[order], p[order]
        pre[b, :live] = rng.integers(0, m, live)
    w = rng.normal(0, 50, (nb, eb)).astype(np.float32)
    chan = rng.integers(0, 2, (nb, eb)).astype(np.int32)
    return pre, post, w, delay, chan


GATHER_CASES = [  # nb, eb, pb, m, d_max, t  (t < d_max: first D steps)
    (2, 128, 128, 64, 4, 1),
    (3, 256, 64, 300, 16, 7),
    (1, 512, 256, 1024, 16, 2000),
    (4, 128, 32, 96, 7, 0),
]


@pytest.mark.parametrize("with_fresh", [False, True])
@pytest.mark.parametrize("nb,eb,pb,m,d_max,t", GATHER_CASES)
def test_gather_plain_matches_pallas(nb, eb, pb, m, d_max, t, with_fresh):
    rng = np.random.default_rng(nb * 7919 + eb + t)
    pre, post, w, delay, chan = sorted_blocked(rng, nb, eb, pb, m, d_max)
    assert (delay == 0).any(), "no padding slots - vacuous"
    ring = (rng.uniform(size=(d_max, m)) < 0.3).astype(np.float32)
    fresh = ((rng.uniform(size=m) < 0.3).astype(np.float32)
             if with_fresh else None)
    ex_r, in_r, arr_r = ref_gather(
        *map(jnp.asarray, (pre, post, w, delay, chan, ring)),
        jnp.asarray(t, jnp.int32), max_delay=d_max, pb=pb, interpret=True,
        emit_arrivals=True,
        fresh=None if fresh is None else jnp.asarray(fresh))
    launches = gather_mod.synaptic_gather.launches
    ex, inh, arr = gather_mod.synaptic_gather(
        *map(torch.from_numpy, (pre, post, w, delay, chan, ring)),
        torch.tensor(t, dtype=torch.int32), max_delay=d_max, pb=pb,
        fresh=None if fresh is None else torch.from_numpy(fresh))
    assert gather_mod.synaptic_gather.launches == launches  # plain path
    # arrivals are copies of ring/fresh bits: exact
    np.testing.assert_array_equal(arr.numpy(), np.asarray(arr_r))
    # row sums: index_add_ vs the one-hot matmul add ~100 terms of |w|~50
    # in different orders; f32 rounding of sums near 1e3 stays below 1e-3
    np.testing.assert_allclose(ex.numpy(), np.asarray(ex_r), atol=1e-3)
    np.testing.assert_allclose(inh.numpy(), np.asarray(in_r), atol=1e-3)


@pytest.mark.parametrize("nb,eb,pb,m,d_max,t", GATHER_CASES)
def test_segment_bounds_walk_reproduces_gather(nb, eb, pb, m, d_max, t):
    """K1's traversal, replayed in numpy: each warp walks its row's
    per-delay runs from the segment table with floor-mod ring rows, and the
    block's tail is padding.  Every slot must be visited exactly once and
    the result must equal the plain twin - the index arithmetic of the
    CUDA source, checked where the card is absent."""
    rng = np.random.default_rng(nb + eb + m)
    pre, post, w, delay, chan = sorted_blocked(rng, nb, eb, pb, m, d_max)
    ring = (rng.uniform(size=(d_max, m)) < 0.3).astype(np.float32)
    bounds = gather_mod.segment_bounds(
        torch.from_numpy(post), torch.from_numpy(delay), pb=pb,
        max_delay=d_max).numpy()
    assert bounds.shape == (nb, d_max * pb + 1) and bounds.dtype == np.int32
    visits = np.zeros((nb, eb), np.int64)
    ex = np.zeros(nb * pb, np.float64)
    arr = np.full((nb, eb), np.nan, np.float32)
    for b in range(nb):
        for r in range(pb):
            for d in range(1, d_max + 1):
                k = (d - 1) * pb + r
                slot = (t - d) % d_max
                for s in range(bounds[b, k], bounds[b, k + 1]):
                    assert delay[b, s] == d and post[b, s] == r
                    visits[b, s] += 1
                    arr[b, s] = ring[slot, pre[b, s]]
                    if chan[b, s] == 0:
                        ex[b * pb + r] += w[b, s] * arr[b, s]
        tail = bounds[b, d_max * pb]
        assert (delay[b, tail:] == 0).all()
        visits[b, tail:] += 1
        arr[b, tail:] = 0.0
    assert (visits == 1).all()
    ex_p, _, arr_p = gather_mod.synaptic_gather_plain(
        *map(torch.from_numpy, (pre, post, w, delay, chan, ring)), t,
        max_delay=d_max, pb=pb)
    np.testing.assert_array_equal(arr, arr_p.numpy())
    # float64 walk vs float32 index_add_: f32 rounding of ~1e3 sums
    np.testing.assert_allclose(ex, ex_p.numpy(), atol=1e-3)


def test_segment_bounds_rejects_unsorted_layout():
    post = torch.tensor([[1, 0, 0, 0]], dtype=torch.int32)
    delay = torch.tensor([[1, 1, 0, 0]], dtype=torch.int32)
    with pytest.raises(ValueError, match="not sorted"):
        gather_mod.segment_bounds(post, delay, pb=2, max_delay=2)
    with pytest.raises(ValueError, match="max_delay"):
        gather_mod.segment_bounds(torch.zeros_like(post), delay + 2, pb=2,
                                  max_delay=2)


def _lif_inputs(rng, n, groups):
    gs = [snn.LIFParams(tau_m=10.0 + 5 * i, t_ref=0.5 + i,
                        tau_syn_ex=0.5 + 0.2 * i) for i in range(groups)]
    f32 = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)
    arrays = dict(
        v=f32(-52, -48), syn_ex=f32(0, 100), syn_in=f32(-100, 100),
        ref_count=rng.integers(0, 4, n).astype(np.int32),
        group_id=rng.integers(0, groups, n).astype(np.int32),
        input_ex=f32(0, 500), input_in=f32(-50, 0))
    ref_gs = [ref_snn.LIFParams(**g.__dict__) for g in gs]
    table = np.array(ref_snn.make_param_table(ref_gs, dt=0.1))
    return arrays, table


@pytest.mark.parametrize("n,groups", [(512, 1), (1000, 3)])
@pytest.mark.parametrize("cond", [False, True])
def test_lif_plain_matches_pallas(n, groups, cond):
    rng = np.random.default_rng(n + groups + cond)
    a, table = _lif_inputs(rng, n, groups)
    pad = (-n) % 128     # the Pallas kernel needs N % nb == 0
    padj = lambda x: jnp.asarray(np.pad(x, (0, pad)))
    out_r = ref_lif_step(*(padj(a[k]) for k in a), jnp.asarray(table),
                         cond=cond, nb=128, interpret=True)
    launches = lif_mod.lif_step.launches
    out_p = lif_mod.lif_step(*(torch.from_numpy(a[k]) for k in a),
                             torch.from_numpy(table), cond=cond)
    assert lif_mod.lif_step.launches == launches
    names = ("v", "syn_ex", "syn_in", "ref_count", "spike")
    assert np.asarray(out_r[4][:n]).any(), "no spikes - vacuous"
    for name, r, p in zip(names, out_r, out_p):
        r = np.asarray(r)[:n]
        if name in ("ref_count", "spike"):
            np.testing.assert_array_equal(p.numpy(), r, err_msg=name)
        else:
            # same op order, but XLA's CPU compiler contracts a*b + c into
            # one FMA where torch rounds twice: an ulp of the operands,
            # which reach 500 here (ulp 3e-5), not of a cancelled result
            np.testing.assert_allclose(p.numpy(), r, rtol=0, atol=1e-4,
                                       err_msg=name)


@pytest.mark.parametrize("pb", [0, 64])
def test_stdp_plain_matches_pallas(pb):
    rng = np.random.default_rng(11 + pb)
    eb, nb, m = 256, 3, 200
    e = eb * nb
    nl = nb * 64 if pb else 150
    post = rng.integers(0, pb if pb else nl, e).astype(np.int32)
    arrays = dict(
        w=rng.uniform(1, 100, e).astype(np.float32),
        pre=rng.integers(0, m, e).astype(np.int32), post=post,
        plastic=rng.uniform(size=e) < 0.7,
        arrived=(rng.uniform(size=e) < 0.3).astype(np.float32),
        spike=(rng.uniform(size=nl) < 0.3).astype(np.float32),
        k_pre=rng.uniform(0, 3, m).astype(np.float32),
        k_post=rng.uniform(0, 3, nl).astype(np.float32))
    w_r = ref_stdp_update(*(jnp.asarray(v) for v in arrays.values()),
                          params=STDP_PARAMS, eb=eb, pb=pb, interpret=True)
    launches = stdp_mod.stdp_update.launches
    w_p = stdp_mod.stdp_update(*(torch.from_numpy(v)
                                 for v in arrays.values()),
                               params=STDP_PARAMS, eb=eb, pb=pb)
    assert stdp_mod.stdp_update.launches == launches
    assert not np.allclose(np.asarray(w_r), arrays["w"]), "no update"
    # exp/log of XLA and of torch differ by a few ulps on weights <= 200
    np.testing.assert_allclose(w_p.numpy(), np.asarray(w_r), rtol=2e-6)


def test_wrappers_refuse_other_devices():
    meta = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="cpu .* or cuda"):
        stdp_mod.stdp_update(meta, meta, meta, meta, meta, meta, meta, meta,
                             params=STDP_PARAMS, eb=4)


@pytest.mark.parametrize("ncol", [snn.NCOL, 11, 14])
def test_check_table_takes_a_composite_view(ncol):
    """A composite model's base columns ``table[:, :-1]`` go to the kernels
    in place: their row stride is ``ncol + 1``.  Overlapping or
    column-strided tables are refused."""
    cpu = torch.device("cpu")
    full = torch.zeros(3, ncol + 1)
    assert _build.check_table(full[:, :-1], ncol, cpu) == ncol + 1
    assert _build.check_table(full[:, :-1].contiguous(), ncol, cpu) == ncol
    with pytest.raises(ValueError, match="shape"):
        _build.check_table(full, ncol, cpu)
    with pytest.raises(ValueError, match="strides"):
        _build.check_table(torch.zeros(ncol, 3).t(), ncol, cpu)
    with pytest.raises(ValueError, match="strides"):
        _build.check_table(torch.zeros(ncol).expand(3, ncol), ncol, cpu)
    with pytest.raises(TypeError, match="dtype"):
        _build.check_table(full[:, :-1].double(), ncol, cpu)
