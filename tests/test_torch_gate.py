"""The activity gate (``"cuda:sparse"``) of the port against the reference's
``"pallas:sparse"`` (DESIGN.md §13).

* the gate policy (``core/autotune.py``): ``gate_capacity``, the measured
  records and ``degree_signature`` equal the reference's;
* the registry: ``cuda:sparse:<rate>`` variants resolve outside it;
* the twins of K6 and K7 against the reference's Pallas kernels (interpret
  mode) on compacted inputs with sentinel rows, and a numpy replay of each
  kernel's list walk;
* the reference's localized fixtures, both halves (sweep and STDP): the
  port's ``"cuda:sparse"`` equals the port's ``"cuda"`` bitwise, with the
  reference's ``"pallas:sparse"`` as the oracle of ``n_active``, overflow
  and values;
* a 120-step trajectory: ``"cuda:sparse"`` and a forced capacity of two
  blocks of five against the reference's rasters and ``gate_overflow``.

Inputs come from numpy with a seed and go to both packages.
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import dataclasses
import gc
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autotune as ref_autotune
from repro.core import backends as ref_backends
from repro.core import builder as ref_builder
from repro.core import engine as ref_engine
from repro.core import models as ref_models
from repro.core import snn as ref_snn
from repro.core import stdp as ref_stdp
from repro.core.layout import BlockedGraph as RefBlockedGraph
from repro.kernels.stdp_update import stdp_update_worklist as ref_stdp_wl
from repro.kernels.synaptic_gather import blocked_reduce_sweep as ref_reduce
from repro_torch import convert
from repro_torch.core import autotune, backends, builder, engine, models
from repro_torch.core import snn, stdp
from repro_torch.core.layout import BlockedGraph
from repro_torch.kernels import stdp_update as stdp_mod
from repro_torch.kernels import synaptic_gather as gather_mod

CPU = "cpu"
STDP_PARAMS = (0.1, 0.0513, 0.4, 45.61, 0.0, 200.0)


# --------------------------------------------------------------------------
# gate policy
# --------------------------------------------------------------------------

CAPACITY_CASES = [  # nb, n_edges, rate, min_capacity
    (100, 100 * 2048, 1.0, 8), (100, 100, 1e-6, 8), (4, 4 * 2048, 0.5, 8),
    (1000, 1000 * 500, 1e-4, 8), (1000, 1000 * 500, 1e-2, 8),
    (44, 12_656_250, 0.002, 8), (44, 12_656_250, 1e-5, 8),
    (44, 12_656_250, 1e-6, 8), (44, 12_656_250, 1e-7, 8),
    (3, 30_000, 1e-5, 1), (64, 64 * 2048, 3e-6, 2),
]


def test_gate_capacity_matches_reference():
    for nb, ne, rate, mc in CAPACITY_CASES:
        assert autotune.gate_capacity(nb, ne, rate, min_capacity=mc) == \
            ref_autotune.gate_capacity(nb, ne, rate, min_capacity=mc)
    # the hpc_benchmark(1.0) values of the gate (NB 44, EB 288 000): only a
    # forced rate leaves blocks off the list
    caps = [autotune.gate_capacity(44, 44 * 288_000, r)
            for r in (0.002, 1e-5, 1e-6, 1e-7)]
    assert caps == [44, 42, 12, 8]
    for bad in (0.0, 1.5, "0.01"):
        with pytest.raises(ValueError):
            autotune.gate_capacity(10, 100, bad)
    for frac in (0.003, 0.0, 0.9, 0.123456):
        assert autotune.recommend_gate_rate(frac) == \
            ref_autotune.recommend_gate_rate(frac)


def test_measured_gate_capacity_matches_reference(tmp_path):
    recs = [{"name": "gate_tune/abc/cap4", "overflow_rate": 0.25,
             "occupancy": 0.9},
            {"name": "gate_tune/abc/cap8", "overflow_rate": 0.0,
             "occupancy": 0.5},
            {"name": "gate_tune/abc/cap16", "overflow_rate": 0.0,
             "occupancy": 0.2},
            {"name": "gate_tune/hot/cap4", "overflow_rate": 0.5,
             "occupancy": 1.0},
            {"name": "gate_tune/hot/cap6", "overflow_rate": 0.5,
             "occupancy": 1.0},
            {"name": "gate_tune/bad", "overflow_rate": 0.0},
            {"name": "shape_tune/abc/pb256xeb2048", "us_per_call": 3.0}]
    path = tmp_path / "BENCH_gate.json"
    path.write_text(json.dumps({"records": recs}))
    got = autotune.load_measured_gate(str(path))
    assert got == ref_autotune.load_measured_gate(str(path))
    assert set(got) == {("abc", 4), ("abc", 8), ("abc", 16), ("hot", 4),
                        ("hot", 6)}
    for sig in ("abc", "hot", "none", None):
        for nb, mc in ((44, 8), (5, 2), (64, 1)):
            assert autotune.measured_gate_capacity(
                got, sig, nb=nb, min_capacity=mc) == \
                ref_autotune.measured_gate_capacity(
                    got, sig, nb=nb, min_capacity=mc)
    spec = f"measured:{path}"
    assert autotune.gate_capacity(44, 10_000, spec, signature="abc") == 8
    with pytest.warns(RuntimeWarning, match="no gate_tune record"):
        cap = autotune.gate_capacity(44, 10_000, spec, signature="zzz")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert cap == ref_autotune.gate_capacity(44, 10_000, spec,
                                                 signature="zzz")
    assert autotune.load_measured_gate(str(tmp_path / "missing.json")) == {}


@pytest.mark.parametrize("n_shards", [1, 4])
def test_degree_signature_matches_reference(n_shards):
    ref_spec, _ = ref_models.hpc_benchmark(0.02)
    ref_gs = ref_builder.build_shards(
        ref_spec, ref_builder.decompose(ref_spec, n_shards))
    spec, _ = models.hpc_benchmark(0.02)
    gs = builder.build_shards(spec, builder.decompose(spec, n_shards))
    degs = autotune.degrees_from_graphs(gs)
    ref_degs = ref_autotune.degrees_from_graphs(ref_gs)
    assert len(degs) == n_shards
    for a, b in zip(degs, ref_degs):
        np.testing.assert_array_equal(a, b)
    sig = autotune.degree_signature(degs)
    assert sig == ref_autotune.degree_signature(ref_degs)
    # the same signature from the graphs on the device (torch fields)
    assert autotune.degree_signature(autotune.degrees_from_graphs(
        [g.to(CPU) for g in gs])) == sig


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

def test_registry_stable_under_variant_resolution():
    before = backends.available_backends()
    assert before == ("bucketed", "cuda", "cuda:sparse", "flat")
    s1 = backends.get_backend("cuda:sparse:0.01")
    s2 = backends.get_backend("cuda:sparse:0.010")   # same canonical rate
    assert s1 is s2 and isinstance(s1, backends.CudaSparseBackend)
    assert s1.gate_rate == 0.01 and s1.name == "cuda:sparse:0.01"
    assert backends.get_backend("cuda:sparse").gated
    assert not backends.get_backend("cuda").gated
    assert backends.get_backend("cuda:sparse").name == "cuda:sparse"
    m = backends.get_backend("cuda:sparse:measured:/nowhere.json")
    assert m.gate_rate == "measured:/nowhere.json"
    assert backends.get_backend("cuda:sparse:measured:/nowhere.json") is m
    assert backends.get_backend("cuda:auto") is backends.get_backend(
        "cuda:auto")
    assert backends.available_backends() == before
    for bad in ("cuda:sparse:nope", "cuda:sparse:0", "cuda:sparse:2.0",
                "cuda:sparse:", "cuda:dense", "pallas:sparse"):
        with pytest.raises(ValueError):
            backends.get_backend(bad)
    with pytest.raises(ValueError):
        backends.CudaSparseBackend(gate_rate="0.01")
    assert backends.available_backends() == before


def test_backend_caches_release_a_dead_graph():
    """A backend's layout cache holds device tensors as large as the graph:
    when the graph is freed, every backend that prepared it lets go."""
    spec, _ = models.hpc_benchmark(0.02)
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(CPU)
    bes = [backends.get_backend(n) for n in ("cuda", "cuda:sparse", "flat",
                                             "cuda:sparse:1e-6")]
    before = [len(b._layouts) for b in bes]
    lays = [b.prepare(g) for b in bes]
    assert all(b.prepare(g) is lay for b, lay in zip(bes, lays))  # cached
    assert [len(b._layouts) for b in bes] == [n + 1 for n in before]
    del g, lays
    gc.collect()
    assert [len(b._layouts) for b in bes] == before


# --------------------------------------------------------------------------
# K6 and K7 twins against the reference's Pallas kernels
# --------------------------------------------------------------------------

def sorted_blocked(rng, nb, eb, pb, m, d_max):
    """Random blocked ELL arrays in the builder's slot order: each block's
    live slots sorted by (delay, post), padding (delay 0) at the tail."""
    pre = np.zeros((nb, eb), np.int32)
    post = np.zeros((nb, eb), np.int32)
    delay = np.zeros((nb, eb), np.int32)
    for b in range(nb):
        live = int(rng.integers(eb // 2, eb))
        d = rng.integers(1, d_max + 1, live)
        p = rng.integers(0, pb, live)
        order = np.lexsort((p, d))
        delay[b, :live], post[b, :live] = d[order], p[order]
        pre[b, :live] = rng.integers(0, m, live)
    w = rng.normal(0, 50, (nb, eb)).astype(np.float32)
    chan = rng.integers(0, 2, (nb, eb)).astype(np.int32)
    return pre, post, w, delay, chan


def _worklist(blocks, cap, nb):
    wl = np.full(cap, nb, np.int32)
    wl[:len(blocks)] = sorted(blocks)
    return wl


def _compacted(walked, cap, nb):
    """The reference's worklist for the blocks a list walks: them, then
    the sentinel NB up to the capacity."""
    return np.asarray(walked + [nb] * max(cap - len(walked), 0), np.int32)


WORKLISTS = {  # name -> (listed blocks of 6, capacity, n_active)
    "partial": ([1, 4], 3, 2),
    "empty": ([], 3, 0),
    "identity": (list(range(6)), 6, 6),
    "saturated": ([0, 2, 3], 3, 5),   # n_active > cap: every block
}


@pytest.mark.parametrize("case", sorted(WORKLISTS))
def test_reduce_plain_matches_pallas(case):
    blocks, cap, n_act = WORKLISTS[case]
    nb, eb, pb, m, d = 6, 256, 64, 300, 8
    rng = np.random.default_rng(len(case) + cap)
    pre, post, w, delay, chan = sorted_blocked(rng, nb, eb, pb, m, d)
    arrived = np.where(delay > 0, rng.uniform(size=(nb, eb)) < 0.3,
                       0).astype(np.float32)
    wl = _worklist(blocks, cap, nb)
    launches = gather_mod.blocked_reduce_sweep.launches
    ex, inh = gather_mod.blocked_reduce_sweep(
        *map(torch.from_numpy, (post, delay, w, arrived, chan)),
        max_delay=d, pb=pb, worklist=torch.from_numpy(wl),
        n_active=torch.tensor(n_act, dtype=torch.int32))
    assert gather_mod.blocked_reduce_sweep.launches == launches
    walked = list(range(nb)) if n_act > cap else blocks
    # the reference on the list's compacted inputs, sentinel rows included
    # (its takes clip them; their output rows are the caller's to drop)
    wl_r = jnp.asarray(_compacted(walked, cap, nb))
    take = lambda a: jnp.take(jnp.asarray(a), wl_r, axis=0)
    ex_r, in_r = ref_reduce(take(post), take(w), take(arrived), take(chan),
                            pb=pb, interpret=True)
    want_ex = np.zeros((nb, pb), np.float32)
    want_in = np.zeros((nb, pb), np.float32)
    for i, b in enumerate(walked):
        want_ex[b], want_in[b] = np.asarray(ex_r)[i], np.asarray(in_r)[i]
    # index_add_ against the one-hot matmul: ~10 terms of |w|~50 each
    np.testing.assert_allclose(ex.numpy(), want_ex.reshape(-1), atol=1e-3)
    np.testing.assert_allclose(inh.numpy(), want_in.reshape(-1), atol=1e-3)
    dead = np.setdiff1d(np.arange(nb), walked)
    assert (ex.numpy().reshape(nb, pb)[dead] == 0).all()
    # on the walked blocks, K6's twin equals K1's twin bitwise
    ex1, in1 = gather_mod.blocked_reduce_sweep_plain(
        *map(torch.from_numpy, (post, w, arrived, chan)), pb=pb)
    rows = np.zeros(nb, bool)
    rows[walked] = True
    rows = np.repeat(rows, pb)
    assert torch.equal(ex[rows], ex1[rows]) and torch.equal(inh[rows],
                                                            in1[rows])


@pytest.mark.parametrize("case", sorted(WORKLISTS))
def test_stdp_worklist_plain_matches_pallas(case):
    blocks, cap, n_act = WORKLISTS[case]
    nb, eb, pb, m = 6, 256, 64, 200
    nl = nb * pb - pb // 2
    rng = np.random.default_rng(17 + cap + n_act)
    e = nb * eb
    a = dict(w=rng.uniform(1, 100, e).astype(np.float32),
             pre=rng.integers(0, m, e).astype(np.int32),
             post=rng.integers(0, pb, e).astype(np.int32),
             plastic=rng.uniform(size=e) < 0.7,
             arrived=(rng.uniform(size=e) < 0.3).astype(np.float32))
    a["post"][-eb:] %= pb // 2         # the ragged block's real rows
    sp = (rng.uniform(size=nl) < 0.3).astype(np.float32)
    kpre = rng.uniform(0, 3, m).astype(np.float32)
    kpost = rng.uniform(0, 3, nl).astype(np.float32)
    wl = _worklist(blocks, cap, nb)
    w = torch.from_numpy(a["w"].copy())
    launches = stdp_mod.stdp_update_worklist.launches
    out = stdp_mod.stdp_update_worklist(
        w, *(torch.from_numpy(a[k]) for k in ("pre", "post", "plastic",
                                              "arrived")),
        torch.from_numpy(wl), torch.tensor(n_act, dtype=torch.int32),
        *map(torch.from_numpy, (sp, kpre, kpost)), params=STDP_PARAMS,
        eb=eb, pb=pb)
    assert stdp_mod.stdp_update_worklist.launches == launches
    assert out is w, "K7 updates in place"
    walked = list(range(nb)) if n_act > cap else blocks
    wl_r = _compacted(walked, cap, nb)
    blk = lambda k: jnp.take(jnp.asarray(a[k].reshape(nb, eb)),
                             jnp.asarray(wl_r), axis=0)
    w_r = np.asarray(ref_stdp_wl(
        blk("w"), blk("pre"), blk("post"), blk("plastic"), blk("arrived"),
        jnp.asarray(wl_r), *map(jnp.asarray, (sp, kpre, kpost)),
        params=STDP_PARAMS, pb=pb, interpret=True))
    got = out.numpy().reshape(nb, eb)
    old = a["w"].reshape(nb, eb)
    for i, b in enumerate(walked):
        # exp/log of XLA and of torch: a few ulps on weights <= 200
        np.testing.assert_allclose(got[b], w_r[i], rtol=2e-6)
    dead = np.setdiff1d(np.arange(nb), walked)
    np.testing.assert_array_equal(got[dead], old[dead])
    if walked:
        assert not np.array_equal(got[walked], old[walked]), "vacuous"
    # on the walked blocks, K7's twin equals K3's twin bitwise
    w3 = stdp_mod.stdp_update_plain(
        *(torch.from_numpy(a[k]) for k in ("w", "pre", "post", "plastic",
                                           "arrived")),
        *map(torch.from_numpy, (sp, kpre, kpost)), params=STDP_PARAMS,
        eb=eb, pb=pb).numpy().reshape(nb, eb)
    np.testing.assert_array_equal(got[walked], w3[walked])


def _grid_walk(nb, n_list_of, cap, wl, n_active):
    """The blocks the kernels' grids reach, replayed from their CUDA index
    arithmetic: K6's warp ``v`` serves list entry ``v // pb``, K7's grid
    row ``y`` list entry ``y``; both walk the identity list when
    ``n_active > cap`` and skip entries outside [0, NB)."""
    identity = n_active > cap
    n_list = nb if identity else n_active
    out = []
    for g in range(n_list_of):
        if g >= n_list:
            continue
        b = g if identity else int(wl[g])
        if 0 <= b < nb:
            out.append(b)
    return out


@pytest.mark.parametrize("case", sorted(WORKLISTS))
def test_kernel_list_walk_matches_listed_blocks(case):
    """The list arithmetic of both CUDA sources, checked where the card is
    absent: the grids (sized for the identity list) reach exactly the
    blocks :func:`listed_blocks` names, each once."""
    blocks, cap, n_act = WORKLISTS[case]
    nb = 6
    wl = _worklist(blocks, cap, nb)
    walked = _grid_walk(nb, nb, cap, wl, n_act)
    assert len(walked) == len(set(walked))
    live = gather_mod.listed_blocks(torch.from_numpy(wl),
                                    torch.tensor(n_act, dtype=torch.int32),
                                    nb)
    assert sorted(walked) == np.flatnonzero(live.numpy()).tolist()


# --------------------------------------------------------------------------
# the reference's localized fixture, in the builder's slot order
# --------------------------------------------------------------------------

def _localized_arrays(nb=12, pb=128, eb=256, max_delay=4, seed=0):
    """``tests/test_sparse_backend.py::_localized_layout``'s draws (pre i's
    edges land only in block i // 8; n_local % PB != 0), each block's live
    slots then sorted by (delay, post), padding at the tail, so that the
    run table of K1 and K6 applies."""
    rng = np.random.default_rng(seed)
    n_local = nb * pb - pb // 2
    a = {k: np.zeros((nb, eb), dt) for k, dt in (
        ("pre", np.int32), ("post", np.int32), ("delay", np.int32),
        ("channel", np.int32), ("plastic", bool), ("weight", np.float32))}
    for b in range(nb):
        ne = eb - 16
        a["pre"][b, :ne] = rng.integers(b * 8, (b + 1) * 8, ne)
        hi = pb if (b + 1) * pb <= n_local else n_local - b * pb
        a["post"][b, :ne] = rng.integers(0, hi, ne)
        a["delay"][b, :ne] = rng.integers(1, max_delay + 1, ne)
        a["channel"][b, :ne] = rng.integers(0, 2, ne)
        a["plastic"][b, :ne] = rng.uniform(size=ne) < 0.7
        a["weight"][b, :ne] = rng.uniform(1.0, 50.0, ne)
        order = np.lexsort((a["post"][b, :ne], a["delay"][b, :ne]))
        for k in a:
            a[k][b, :ne] = a[k][b, :ne][order]
    return a, dict(nb=nb, pb=pb, eb=eb, n_local=n_local, n_mirror=nb * 8,
                   max_delay=max_delay)


def _ref_layout(a, geo):
    nb, eb = geo["nb"], geo["eb"]
    bg = RefBlockedGraph(
        nb=nb, eb=eb, pb=geo["pb"], n_local=geo["n_local"],
        pre_idx=jnp.asarray(a["pre"]), post_rel=jnp.asarray(a["post"]),
        delay=jnp.asarray(a["delay"]), channel=jnp.asarray(a["channel"]),
        plastic=jnp.asarray(a["plastic"]),
        edge_perm=jnp.asarray(np.arange(nb * eb, dtype=np.int32).reshape(
            nb, eb)), weight=None)
    flat = lambda k: jnp.asarray(a[k].reshape(-1))
    return ref_backends.EdgeLayout(
        n_local=geo["n_local"], n_mirror=geo["n_mirror"],
        max_delay=geo["max_delay"], pre_idx=flat("pre"),
        post_idx=flat("post"), delay=flat("delay"),
        channel=flat("channel"), plastic=flat("plastic"), blocked=bg)


def _port_graph(a, geo):
    """A port ShardGraph carrying the fixture (edge_perm the identity)."""
    nb, eb = geo["nb"], geo["eb"]
    t = lambda k, dt: torch.from_numpy(a[k]).to(dt)
    bg = BlockedGraph(
        nb=nb, eb=eb, pb=geo["pb"], n_local=geo["n_local"],
        pre_idx=t("pre", torch.int32), post_rel=t("post", torch.int32),
        delay=t("delay", torch.int32), channel=t("channel", torch.int32),
        plastic=t("plastic", torch.bool),
        edge_perm=torch.arange(nb * eb, dtype=torch.int32).reshape(nb, eb),
        weight=None)
    flat = lambda k, dt: t(k, dt).reshape(-1)
    return engine.ShardGraph(
        n_local=geo["n_local"], n_mirror=geo["n_mirror"],
        max_delay=geo["max_delay"], pre_idx=flat("pre", torch.int32),
        post_idx=flat("post", torch.int32),
        delay=flat("delay", torch.int32),
        channel=flat("channel", torch.int32),
        plastic=flat("plastic", torch.bool),
        weight_init=flat("weight", torch.float32), bucket_ptr=None,
        mirror_src_shard=None, mirror_src_idx=None, group_id=None,
        blocked=bg)


def _gates(geo, a):
    """The backends of a fixture comparison and their layouts: the port's
    cuda and cuda:sparse, the reference's pallas:sparse, the gate at rate
    1e-3 with floor 2 (the same capacity on both sides)."""
    g = _port_graph(a, geo)
    dense, gated = backends.get_backend("cuda"), backends.CudaSparseBackend(
        gate_rate=1e-3, min_capacity=2)
    ref_lay = _ref_layout(a, geo)
    ref_gated = ref_backends.SparsePallasBackend(gate_rate=1e-3,
                                                 min_capacity=2)
    cap = gated.gate_capacity(gated.prepare(g))
    assert cap == ref_gated.gate_capacity(ref_lay)
    assert 2 <= cap < geo["nb"], "the fixture must exercise a real gate"
    return dense, dense.prepare(g), gated, gated.prepare(g), ref_gated, \
        ref_lay


def _sweep_case(case, geo):
    """(ring, fresh, expected n_active, expected overflow) at t = 5."""
    d, m, nb = geo["max_delay"], geo["n_mirror"], geo["nb"]
    ring = np.zeros((d, m), np.float32)
    fresh = None
    if case == "zero_spike":
        want = (0, 0)
    elif case == "single_block":
        ring[(5 - 2) % d, 3] = 1.0        # pre 3 lives in block 0
        want = (1, 0)
    elif case == "saturating":
        ring[:] = 1.0                     # every block: dense fallback
        want = (nb, 1)
    elif case == "overlap_fresh":
        fresh = np.zeros(m, np.float32)
        fresh[9] = 1.0                    # delay-1 arrival in block 1
        want = (1, 0)
    else:                                 # ragged_tail: the last block
        ring[(5 - 3) % d, 8 * (nb - 1) + 5] = 1.0
        want = (1, 0)
    return ring, fresh, want


FIXTURE_CASES = ["zero_spike", "single_block", "saturating",
                 "overlap_fresh", "ragged_tail"]


@pytest.mark.parametrize("case", FIXTURE_CASES)
def test_gated_sweep_equals_dense_on_localized_fixture(case):
    a, geo = _localized_arrays()
    assert geo["n_local"] % geo["pb"] != 0
    dense, ld, gated, lg, ref_gated, ref_lay = _gates(geo, a)
    ring, fresh, (want_n, want_ovf) = _sweep_case(case, geo)
    t = torch.tensor(5, dtype=torch.int32)
    w = torch.from_numpy(a["weight"].reshape(-1))
    r = torch.from_numpy(ring)
    if fresh is None:
        ex_d, in_d, ar_d = dense.sweep(ld, w, r, t)
        ex_s, in_s, ar_s, ovf = gated.sweep_with_stats(lg, w, r, t)
        ex_r, in_r, ar_r, ovf_r = ref_gated.sweep_with_stats(
            ref_lay, jnp.asarray(w.numpy()), jnp.asarray(ring), 5)
    else:
        f = torch.from_numpy(fresh)
        ex_d, in_d, ar_d, ring_d = dense.sweep_overlap(ld, w, r, t, f)
        ex_s, in_s, ar_s, ring_s, ovf = gated.sweep_overlap_with_stats(
            lg, w, r, t, f)
        assert torch.equal(ring_d, ring_s)
        ex_r, in_r, ar_r, _, ovf_r = ref_gated.sweep_overlap_with_stats(
            ref_lay, jnp.asarray(w.numpy()), jnp.asarray(ring), 5,
            jnp.asarray(fresh))
    # the port's gate equals its dense pass bitwise
    for x, y in ((ex_d, ex_s), (in_d, in_s), (ar_d, ar_s)):
        assert torch.equal(x, y)
    # the reference's gate is the oracle of the decision and the values
    counts, n_active, cap = gated.gate_stats(
        lg, r, t, None if fresh is None else torch.from_numpy(fresh))
    counts_r, n_r, _ = ref_gated.gate_stats(
        ref_lay, jnp.asarray(ring), 5,
        None if fresh is None else jnp.asarray(fresh))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_r))
    assert (int(n_active), int(ovf)) == (int(n_r), int(ovf_r)) \
        == (want_n, want_ovf)
    np.testing.assert_array_equal(ar_s.numpy(), np.asarray(ar_r))
    np.testing.assert_allclose(ex_s.numpy(), np.asarray(ex_r), atol=1e-4)
    np.testing.assert_allclose(in_s.numpy(), np.asarray(in_r), atol=1e-4)
    if want_n:
        assert ex_s.abs().sum() + in_s.abs().sum() > 0, "vacuous"


STDP_CASES = ["zero_spike", "single_block", "post_spike_only",
              "saturating", "overlap_fresh", "ragged_tail"]


@pytest.mark.parametrize("case", STDP_CASES)
def test_gated_stdp_equals_dense_on_localized_fixture(case):
    a, geo = _localized_arrays(seed=1)
    dense, ld, gated, lg, ref_gated, ref_lay = _gates(geo, a)
    nb, pb, nl = geo["nb"], geo["pb"], geo["n_local"]
    rng = np.random.default_rng(2)
    k_pre = rng.uniform(0, 1, geo["n_mirror"]).astype(np.float32)
    k_post = rng.uniform(0, 1, nl).astype(np.float32)
    ring, fresh, _ = _sweep_case(
        "zero_spike" if case == "post_spike_only" else case, geo)
    sp = np.zeros(nl, np.float32)
    if case == "post_spike_only":
        sp[3 * pb + 7] = 1.0                       # a row of block 3
    elif case == "saturating":
        sp = (rng.uniform(size=nl) < 0.5).astype(np.float32)
    elif case == "ragged_tail":
        sp[nl - 1] = 1.0                           # last real row
    t = torch.tensor(5, dtype=torch.int32)
    f = None if fresh is None else torch.from_numpy(fresh)
    arrived = gated._blocked_arrivals(lg, torch.from_numpy(ring), t,
                                      f).reshape(-1)
    w = torch.from_numpy(a["weight"].reshape(-1))
    params = models.HPC_STDP
    # weights INSIDE [w_min, w_max]: the bit-exactness precondition
    assert params.w_min <= float(w.min()) <= float(w.max()) <= params.w_max
    traces = stdp.TraceState(k_pre=torch.from_numpy(k_pre),
                             k_post=torch.from_numpy(k_post))
    w_d = dense.stdp_update(ld, w, arrived, torch.from_numpy(sp), traces,
                            params)
    w_in = w.clone()
    w_s = gated.stdp_update(lg, w_in, arrived, torch.from_numpy(sp), traces,
                            params)
    assert w_s is w_in, "K7 updates in place"
    assert torch.equal(w_d, w_s)
    ref_traces = ref_stdp.TraceState(k_pre=jnp.asarray(k_pre),
                                     k_post=jnp.asarray(k_post))
    w_r = ref_gated.stdp_update(ref_lay, jnp.asarray(w.numpy()),
                                jnp.asarray(arrived.numpy()),
                                jnp.asarray(sp), ref_traces,
                                ref_models.HPC_STDP)
    np.testing.assert_allclose(w_s.numpy(), np.asarray(w_r), rtol=2e-6)
    changed = not torch.equal(w_s, w)
    assert changed == (case != "zero_spike"), "vacuous or spurious update"


# --------------------------------------------------------------------------
# trajectories
# --------------------------------------------------------------------------

TRAJ_STEPS = 120


def _ref_drives(g_ref, key, n_steps, dt=0.1):
    """The reference's per-step Poisson drive, replayed from its key
    stream (``engine_step`` splits the key each step)."""
    gd = g_ref.device_arrays()
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(ref_engine._poisson_drive(sub, gd, dt,
                                                        jnp.float32)))
    return np.stack(out)


@pytest.fixture(scope="module")
def trajectory_setup():
    """hpc_benchmark(0.1, stdp=True) (NB 5, n_local % 256 != 0) from one
    random state around threshold; the reference's rasters and overflow
    under ``pallas`` and under ``pallas:sparse`` at rate 1e-5, floor 1
    (capacity 2)."""
    ref_spec, ref_stdp_params = ref_models.hpc_benchmark(0.1, stdp=True)
    g_ref = ref_builder.build_shards(ref_spec,
                                     ref_builder.decompose(ref_spec, 1))[0]
    assert g_ref.n_local % 256 != 0
    gd = g_ref.device_arrays()
    table = ref_snn.make_param_table(list(ref_spec.groups), dt=0.1)
    v0 = np.random.default_rng(4).uniform(-56.0, -49.5, g_ref.n_local)
    ref = {}
    for be in ("pallas", ref_backends.SparsePallasBackend(gate_rate=1e-5,
                                                          min_capacity=1)):
        cfg = ref_engine.EngineConfig(dt=0.1, stdp=ref_stdp_params,
                                      sweep=be)
        st = ref_engine.init_state(gd, list(ref_spec.groups),
                                   jax.random.key(0), sweep=be)
        st = dataclasses.replace(st, neurons=dataclasses.replace(
            st.neurons, v_m=jnp.asarray(v0, jnp.float32)))
        fin, sp = jax.jit(lambda s, c=cfg: ref_engine.run(
            s, gd, table, c, TRAJ_STEPS))(st)
        ref["sparse" if isinstance(be, ref_backends.SparsePallasBackend)
            else be] = (np.asarray(sp), int(fin.gate_overflow), st)
    fields = {f.name: getattr(g_ref, f.name)
              for f in dataclasses.fields(g_ref)}
    g = convert.graph_from_numpy(fields).to(CPU)
    drive = torch.from_numpy(_ref_drives(g_ref, jax.random.key(0),
                                         TRAJ_STEPS))
    return ref, g, torch.from_numpy(np.array(table)), drive


def _port_run(setup, sweep):
    ref, g, table, drive = setup
    st_ref = ref["pallas"][2]
    leaves = {k: np.asarray(v) for k, v in {
        "neurons.v_m": st_ref.neurons.v_m,
        "neurons.syn_ex": st_ref.neurons.syn_ex,
        "neurons.syn_in": st_ref.neurons.syn_in,
        "neurons.ref_count": st_ref.neurons.ref_count,
        "neurons.spike": st_ref.neurons.spike, "ring": st_ref.ring,
        "weights": st_ref.weights, "traces.k_pre": st_ref.traces.k_pre,
        "traces.k_post": st_ref.traces.k_post, "t": st_ref.t,
        "gate_overflow": st_ref.gate_overflow}.items()}
    st = convert.state_from_numpy(leaves, g, sweep=sweep, device=CPU)
    cfg = engine.EngineConfig(dt=0.1, stdp=models.HPC_STDP, sweep=sweep)
    w0 = st.weights.clone()
    fin, sp = engine.run(st, g, table, cfg, TRAJ_STEPS, drive=drive,
                         device=CPU)
    assert torch.equal(st.weights, w0), "run changed the caller's weights"
    return fin, sp


def test_gated_trajectory_equals_dense_and_reference(trajectory_setup):
    """120 steps with STDP and the reference's drive: ``cuda:sparse`` (the
    full-capacity gate) and a gate forced to two blocks of five give the
    port's ``cuda`` spikes, voltages and weights bitwise, the reference's
    rasters, and the reference's ``gate_overflow``."""
    ref = trajectory_setup[0]
    fin_d, sp_d = _port_run(trajectory_setup, "cuda")
    sp_ref, ovf_ref, _ = ref["pallas"]
    sp_refs, ovf_refs, _ = ref["sparse"]
    assert sp_ref.sum() > 50, "vacuous - nothing spiked"
    np.testing.assert_array_equal(sp_ref, sp_refs)
    assert ovf_ref == 0 and 0 < ovf_refs < TRAJ_STEPS, "both branches"
    np.testing.assert_array_equal(sp_d.numpy(), sp_ref)
    forced = backends.CudaSparseBackend(gate_rate=1e-5, min_capacity=1)
    assert forced.gate_capacity(forced.prepare(trajectory_setup[1])) == 2
    for sweep, want_ovf in (("cuda:sparse", 0), (forced, ovf_refs)):
        fin, sp = _port_run(trajectory_setup, sweep)
        assert torch.equal(sp, sp_d)
        assert torch.equal(fin.neurons.v_m, fin_d.neurons.v_m)
        assert torch.equal(fin.weights, fin_d.weights)
        assert fin.gate_overflow.shape == ()
        assert int(fin.gate_overflow) == want_ovf
    assert int(fin_d.gate_overflow) == 0


def test_state_without_gate_overflow_steps():
    """A state made without ``gate_overflow`` (None) steps and runs: the
    count starts from 0, as the reference normalizes it."""
    spec, stdp_params = models.hpc_benchmark(0.05, stdp=True)
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(CPU)
    table = snn.make_param_table(list(spec.groups), 0.1, device=CPU)
    sweep = backends.CudaSparseBackend(gate_rate=1e-6, min_capacity=1)
    cfg = engine.EngineConfig(dt=0.1, stdp=stdp_params, sweep=sweep)
    st = engine.init_state(g, list(spec.groups), 0, sweep=sweep, device=CPU)
    assert st.gate_overflow.dtype == torch.int32 and int(st.gate_overflow) \
        == 0
    legacy = dataclasses.replace(st, gate_overflow=None)
    new, _ = engine.engine_step(legacy, g, table, cfg)
    assert new.gate_overflow.shape == () and int(new.gate_overflow) == 0
    fin, _ = engine.run(dataclasses.replace(st, gate_overflow=None), g,
                        table, cfg, 3, device=CPU)
    assert fin.gate_overflow.shape == () and int(fin.gate_overflow) >= 0
    leaves = convert.state_to_numpy(legacy, g)
    assert int(leaves["gate_overflow"]) == 0
    leaves["gate_overflow"] = np.asarray(7, np.int32)
    back = convert.state_from_numpy(leaves, g, sweep="cuda:sparse",
                                    device=CPU)
    assert int(back.gate_overflow) == 7
    del leaves["gate_overflow"]
    assert int(convert.state_from_numpy(leaves, g, sweep="flat",
                                        device=CPU).gate_overflow) == 0
