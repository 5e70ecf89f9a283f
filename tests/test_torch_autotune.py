"""The (PB, EB) block-shape half of the port's ``core/autotune.py`` against
the reference's, and the shapes it threads through the builder, the
stacked builds, the backends and ``convert``.

* the candidates, the choice and the report equal the reference's where
  the two price the same candidates (the reference's VMEM budget lifted;
  at its own budget wherever that budget rejects no candidate);
* the Hopper resource model: the device budget and the kernels' index
  ranges gate feasibility, and nothing feasible raises;
* the measured records (``shape_tune/<signature>/pb{PB}xeb{EB}``) as the
  reference reads and applies them;
* where the two tuners part: hpc_benchmark at scale 1 (degrees only);
* ``build_shards``, ``prepare_stacked`` and ``prepare_stacked_local`` with
  ``block_shapes=``: every array equal to the reference's at the same
  shapes;
* ``"cuda:auto"`` (plain twins) against the reference's ``"pallas:auto"``
  and bitwise against the port's ``"cuda"``.

Inputs come from numpy with a seed and go to both packages.
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import dataclasses
import json
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.core import autotune as ref_autotune
from repro.core import builder as ref_builder
from repro.core import decomposition as ref_decomposition
from repro.core import distributed as ref_dist
from repro.core import engine as ref_engine
from repro.core import models as ref_models
from repro.core import snn as ref_snn
from repro_torch import convert
from repro_torch.core import autotune, backends, builder, decomposition
from repro_torch.core import distributed as dist
from repro_torch.core import engine, models, multihost, snn
from repro_torch.core.layout import BlockedGraph

CPU = "cpu"
NO_VMEM_LIMIT = 2 ** 62
CASES = [(0.02, 1), (0.05, 1), (0.02, 4)]   # hpc scale, uniform shards


def _shards(m, scale, n_dev, **kw):
    spec, _ = m.hpc_benchmark(scale=scale)
    return spec, m_builder(m).build_shards(
        spec, m_builder(m).decompose(spec, n_dev), **kw)


def m_builder(m):
    return ref_builder if m is ref_models else builder


def _key(c):
    return c.pb, c.eb, c.nb, c.padded_slots


# --------------------------------------------------------------------------
# the tuner against the reference's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("scale,n_dev", CASES)
def test_candidates_choice_and_report_equal_reference(scale, n_dev):
    """Same candidates (PB, EB, NB, padded slots), same selection: the
    port's choice is the reference's once the reference's VMEM budget is
    lifted, and the reference's own wherever that budget rejects none of
    them (the uniform 4-shard set); the report agrees field for field but
    for the resource model's bytes."""
    _, ref = _shards(ref_models, scale, n_dev, with_blocked=False)
    _, gs = _shards(models, scale, n_dev, with_blocked=False)
    cands = autotune._candidates(gs, autotune.DEFAULT_PB_CANDIDATES,
                                 autotune.DEFAULT_EB_MULTIPLE,
                                 autotune.DEFAULT_DEVICE_BUDGET)
    ref_cands = ref_autotune._candidates(
        ref, ref_autotune.DEFAULT_PB_CANDIDATES,
        ref_autotune.DEFAULT_EB_MULTIPLE, ref_autotune.DEFAULT_VMEM_BUDGET)
    assert [_key(c) for c in cands] == [_key(c) for c in ref_cands]
    assert all(c.feasible for c in cands)

    chosen = autotune.autotune_block_shapes(gs)
    lifted = ref_autotune.autotune_block_shapes(ref,
                                                vmem_budget=NO_VMEM_LIMIT)
    assert _key(chosen) == _key(lifted)
    if all(c.feasible for c in ref_cands):
        assert _key(chosen) == _key(ref_autotune.autotune_block_shapes(ref))
    g = gs[0]
    assert chosen.device_bytes == autotune.sweep_device_bytes(
        chosen.pb, chosen.eb, nb=chosen.nb, max_delay=g.max_delay,
        n_mirror=g.n_mirror, n_shards=n_dev)

    rep = autotune.autotune_report(gs)
    ref_rep = ref_autotune.autotune_report(ref, vmem_budget=NO_VMEM_LIMIT)
    kib = {"device_kib", "default_device_kib", "vmem_kib",
           "default_vmem_kib"}
    assert {k: v for k, v in rep.items() if k not in kib} == \
        {k: v for k, v in ref_rep.items() if k not in kib}
    assert rep["slots_vs_default"] <= 1.0
    assert rep["pad_ratio"] <= rep["default_pad_ratio"] + 1e-9


def test_the_tuners_part_at_hpc_scale_1():
    """Kept by design.  At ``hpc_benchmark(1.0)`` every candidate pads to
    12 672 000 slots (NB*PB = 11 264, 1 125 edges a row).  The reference
    finds none of them within TPU VMEM (the one-hot tile alone is
    EB*PB*4 bytes) and falls back to the smallest footprint, PB 128; the
    port, pricing the card's bytes, admits all four and breaks the tie
    toward the larger PB: 1024.  Row degrees only, no build."""
    spec, _ = models.hpc_benchmark(1.0, stdp=True)
    degrees = [builder.shard_row_degrees(spec, builder.decompose(spec, 1),
                                         0)]
    ref_spec, _ = ref_models.hpc_benchmark(1.0, stdp=True)
    ref_degrees = [ref_builder.shard_row_degrees(
        ref_spec, ref_builder.decompose(ref_spec, 1), 0)]
    np.testing.assert_array_equal(degrees[0], ref_degrees[0])
    n_local = 11_256      # 11 250 rows padded to a multiple of 8
    kw = dict(n_local=n_local, n_mirror=n_local, max_delay=spec.max_delay)
    for pb in autotune.DEFAULT_PB_CANDIDATES:
        nb = -(-n_local // pb)
        assert nb * pb == 11_264
        assert nb * autotune.eb_from_degrees(degrees[0], n_local,
                                             pb=pb) == 12_672_000
    port = autotune.autotune_block_shapes_from_degrees(degrees, **kw)
    ref = ref_autotune.autotune_block_shapes_from_degrees(ref_degrees, **kw)
    assert (port.pb, port.eb, port.nb, port.feasible) == (1024, 1_152_000,
                                                          11, True)
    assert (ref.pb, ref.eb, ref.feasible) == (128, 144_000, False)
    assert port.padded_slots == ref.padded_slots == 12_672_000
    # with TPU VMEM lifted, the reference's rule picks the port's shape
    lifted = ref_autotune.autotune_block_shapes_from_degrees(
        ref_degrees, vmem_budget=NO_VMEM_LIMIT, **kw)
    assert _key(lifted) == _key(port)


# --------------------------------------------------------------------------
# the Hopper resource model
# --------------------------------------------------------------------------

def test_device_budget_rejects_fat_shapes():
    """At each candidate's own bytes as the budget, the choice is the best
    of the candidates within it; below every candidate the tuner raises
    rather than fall back."""
    _, gs = _shards(models, 0.05, 1, with_blocked=False)
    g = gs[0]
    cands = autotune._candidates(gs, autotune.DEFAULT_PB_CANDIDATES,
                                 autotune.DEFAULT_EB_MULTIPLE,
                                 autotune.DEFAULT_DEVICE_BUDGET)
    assert len({c.device_bytes for c in cands}) == len(cands)
    for c in cands:
        fits = [x for x in cands if x.device_bytes <= c.device_bytes]
        chosen = autotune.autotune_block_shapes(
            gs, device_budget=c.device_bytes)
        assert chosen.feasible and chosen.device_bytes <= c.device_bytes
        assert _key(chosen) == _key(min(
            fits, key=lambda x: (x.padded_slots, -x.pb)))
    ring = (g.max_delay + 1) * g.n_mirror * 4
    with pytest.raises(ValueError, match="no \\(PB, EB\\) candidate"):
        autotune.autotune_block_shapes(gs, device_budget=ring)


def test_device_bytes_and_index_limits():
    """The model's terms at hpc scale 1's tuned shape, the gate's extra
    bytes, and each index range the kernels assume."""
    nb, pb, eb, d, m = 11, 1024, 1_152_000, 16, 11_256
    slots = nb * eb
    want = slots * 33 + nb * (d * pb + 1) * 4 + (d + 1) * m * 4
    assert autotune.sweep_device_bytes(pb, eb, nb=nb, max_delay=d,
                                       n_mirror=m) == want
    assert autotune.sweep_device_bytes(pb, eb, nb=nb, max_delay=d,
                                       n_mirror=m, n_shards=4) == 4 * want
    gated = autotune.gated_sweep_device_bytes(pb, eb, nb=nb, max_delay=d,
                                              n_mirror=m, capacity=8)
    assert gated == want + slots * 5 + (d + 1) * m * 4 + 10 * 4 + nb * 4
    assert autotune.kernel_index_limits(pb, eb, nb=nb, max_delay=d) == []
    assert "grid y" in " ".join(autotune.kernel_index_limits(
        128, 1024, nb=65_536, max_delay=d))
    assert "NB*PB" in " ".join(autotune.kernel_index_limits(
        1024, 1024, nb=2 ** 21, max_delay=d))
    assert "run-table" in " ".join(autotune.kernel_index_limits(
        2 ** 27, 1024, nb=1, max_delay=d))
    assert "slot loops" in " ".join(autotune.kernel_index_limits(
        128, 2 ** 31 - 2048, nb=1, max_delay=d))
    # a shape that breaks a range is infeasible whatever the budget
    c = autotune._shape(128, 1024, nbs=[65_536], max_delay=d, n_mirror=8,
                        budget=2 ** 62)
    assert not c.feasible


def test_resolve_block_shapes_specs():
    _, gs = _shards(models, 0.02, 1, with_blocked=False)
    assert autotune.resolve_block_shapes(gs, None) is None
    auto = autotune.resolve_block_shapes(gs, "auto")
    assert isinstance(auto, autotune.BlockShapes)
    assert autotune.resolve_block_shapes(gs, (128, 512)).as_tuple() == \
        (128, 512)
    assert autotune.resolve_block_shapes(gs, auto) is auto
    for bad in ("fastest", (128,), 256):
        with pytest.raises(ValueError, match="block_shapes"):
            autotune.resolve_block_shapes(gs, bad)
        with pytest.raises(ValueError, match="block_shapes"):
            autotune.resolve_block_shapes_from_degrees(
                [np.ones(8)], bad, n_local=8, n_mirror=8, max_delay=4)


# --------------------------------------------------------------------------
# measured records
# --------------------------------------------------------------------------

def _measured_payload(entries):
    return {"records": [
        {"name": f"shape_tune/{sig}/pb{pb}xeb{eb}", "us_per_call": us}
        for (sig, pb, eb), us in entries.items()]}


def test_load_measured_timings_matches_reference(tmp_path):
    good = {("abc123def456", 128, 1024): 10.5,
            ("abc123def456", 256, 512): 7.0}
    payload = _measured_payload(good)
    payload["records"] += [
        {"name": "snn_step/flat/steps", "us_per_call": 1.0},
        {"name": "shape_tune/short", "us_per_call": 1.0},
        {"name": "shape_tune/abc/pbXxebY", "us_per_call": 1.0},
        {"name": "shape_tune/abc/pb128xeb512"},
        {"name": "gate_tune/abc/cap8", "overflow_rate": 0.0,
         "occupancy": 0.5}]
    p = tmp_path / "BENCH_t.json"
    p.write_text(json.dumps(payload))
    assert autotune.load_measured_timings(str(p)) == good
    assert ref_autotune.load_measured_timings(str(p)) == good
    p.write_text(json.dumps(payload["records"]))     # a bare record list
    assert autotune.load_measured_timings(str(p)) == good
    assert autotune.load_measured_timings(str(tmp_path / "nope.json")) == {}
    bad = tmp_path / "bad.json"
    bad.write_text("not json {")
    assert autotune.load_measured_timings(str(bad)) == {}


def test_measured_timings_break_the_model_tie(tmp_path):
    """A measured table keyed by this network's signature overrides the
    padded-slots model among the feasible candidates, on the graph path
    and the degrees path alike, as the reference's does; another
    network's records, or none, leave the model's choice; the budget still
    gates a measured winner."""
    spec, gs = _shards(models, 0.02, 1, with_blocked=False)
    _, ref = _shards(ref_models, 0.02, 1, with_blocked=False)
    base = autotune.autotune_block_shapes(gs)
    cands = autotune._candidates(gs, autotune.DEFAULT_PB_CANDIDATES,
                                 autotune.DEFAULT_EB_MULTIPLE,
                                 autotune.DEFAULT_DEVICE_BUDGET)
    winner = next(c for c in cands if c.pb != base.pb)
    sig = autotune.degree_signature(autotune.degrees_from_graphs(gs))
    assert sig == ref_autotune.degree_signature(
        ref_autotune.degrees_from_graphs(ref))
    measured = {(sig, winner.pb, winner.eb): 5.0,
                (sig, base.pb, base.eb): 50.0}
    p = tmp_path / "BENCH_m.json"
    p.write_text(json.dumps(_measured_payload(measured)))

    g = gs[0]
    degs = [builder.shard_row_degrees(spec, builder.decompose(spec, 1), 0)]
    kw = dict(n_local=int(g.n_local), n_mirror=int(g.n_mirror),
              max_delay=int(g.max_delay))
    for got in (autotune.autotune_block_shapes(gs, measured=measured),
                autotune.autotune_block_shapes(gs, measured=str(p)),
                autotune.resolve_block_shapes(gs, f"measured:{p}"),
                autotune.autotune_block_shapes_from_degrees(
                    degs, measured=measured, **kw),
                autotune.resolve_block_shapes_from_degrees(
                    degs, f"measured:{p}", **kw),
                ref_autotune.autotune_block_shapes(
                    ref, measured=str(p), vmem_budget=NO_VMEM_LIMIT)):
        assert (got.pb, got.eb) == (winner.pb, winner.eb)
    foreign = {("0" * 12, winner.pb, winner.eb): 5.0}
    assert _key(autotune.autotune_block_shapes(gs, measured=foreign)) == \
        _key(base)
    assert _key(autotune.autotune_block_shapes(
        gs, measured=str(tmp_path / "gone.json"))) == _key(base)
    starved = autotune.autotune_block_shapes_from_degrees(
        degs, measured=measured, device_budget=winner.device_bytes - 1,
        **kw)
    assert starved.pb != winner.pb


# --------------------------------------------------------------------------
# builder, stacked builds, convert
# --------------------------------------------------------------------------

def _assert_blocked_equal(port, ref, what):
    for f in dataclasses.fields(BlockedGraph):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if a is None or b is None:
            assert a is None and b is None, f"{what}: {f.name}"
        elif np.isscalar(a):
            assert a == b, f"{what}: {f.name}"
        else:
            assert np.asarray(a).dtype == np.asarray(b).dtype, f.name
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"{what}: {f.name}")


@pytest.mark.parametrize("n_dev", [1, 4])
def test_build_shards_block_shapes_equal_reference(n_dev):
    """``build_shards(block_shapes="auto")`` lands on the tuner's shape,
    and it and a pinned ``(128, eb)`` build give every ``BlockedGraph``
    field of the reference's build at the same shapes; a pinned EB below
    the widest shard's need raises in both."""
    spec, raw = _shards(models, 0.02, n_dev, with_blocked=False)
    ref_spec, _ = ref_models.hpc_benchmark(scale=0.02)
    dec = builder.decompose(spec, n_dev)
    ref_dec = ref_builder.decompose(ref_spec, n_dev)
    chosen = autotune.autotune_block_shapes(raw)
    eb128 = autotune.autotune_block_shapes(raw, pb_candidates=(128,)).eb
    for spec_arg, ref_arg in (("auto", chosen.as_tuple()),
                              ((128, eb128), (128, eb128))):
        got = builder.build_shards(spec, dec, block_shapes=spec_arg)
        want = ref_builder.build_shards(ref_spec, ref_dec,
                                        block_shapes=ref_arg)
        for g, r in zip(got, want):
            assert (g.blocked.pb, g.blocked.eb) == (
                ref_arg[0], max(ref_arg[1], r.blocked.eb))
            _assert_blocked_equal(g.blocked, r.blocked, str(spec_arg))
    for m, s, d in ((builder, spec, dec), (ref_builder, ref_spec, ref_dec)):
        with pytest.raises(ValueError, match="below the widest"):
            m.build_shards(s, d, block_shapes=(128, 128))
    with pytest.raises(ValueError, match="with_blocked=False"):
        builder.build_shards(spec, dec, with_blocked=False,
                             block_shapes="auto")


@pytest.mark.parametrize("connectivity", ["materialized", "procedural"])
def test_prepare_stacked_block_shapes_equal_reference(connectivity):
    """``prepare_stacked(block_shapes="auto")``: every stacked array equal
    to the reference's net at the same (pinned) shapes, the spec kept on
    the net; procedurally also ``prepare_stacked_local``'s rows and the
    converted reference net."""
    spec, _ = models.hpc_benchmark(scale=0.02)
    ref_spec, _ = ref_models.hpc_benchmark(scale=0.02)
    spec = dataclasses.replace(spec, connectivity=connectivity)
    ref_spec = dataclasses.replace(ref_spec, connectivity=connectivity)
    dec = dist.mesh_decompose(spec, 2, 2)
    net = dist.prepare_stacked(spec, dec, 2, 2, block_shapes="auto")
    nb, eb, pb = net.blocked_meta
    assert net.block_shapes_spec == "auto"
    if connectivity == "materialized":
        raw = builder.build_shards(spec, dec, with_blocked=False)
        assert autotune.autotune_block_shapes(raw).as_tuple() == (pb, eb)
    ref_net = ref_dist.prepare_stacked(
        ref_spec, ref_dist.mesh_decompose(ref_spec, 2, 2), 2, 2,
        block_shapes=(pb, eb))
    assert tuple(ref_net.blocked_meta) == (nb, eb, pb)
    assert sorted(net.graph) == sorted(ref_net.graph)
    for k, v in ref_net.graph.items():
        np.testing.assert_array_equal(net.graph[k], np.asarray(v), k)
    carried = convert.stacked_net_from_numpy(ref_net)
    assert carried.block_shapes_spec == (pb, eb)
    assert convert.stacked_net_from_numpy(dataclasses.replace(
        ref_net, block_shapes_spec="auto")).block_shapes_spec == "auto"
    if connectivity == "procedural":
        local = multihost.prepare_stacked_local(
            spec, dec, 2, 2, multihost.make_host_mesh(2, 2, device=CPU),
            block_shapes="auto")
        assert local.blocked_meta == net.blocked_meta
        assert local.block_shapes_spec == "auto"
        for k, v in net.graph.items():
            np.testing.assert_array_equal(local.graph[k], v, k)
    with pytest.raises(ValueError, match="below the widest"):
        dist.prepare_stacked(spec, dec, 2, 2, block_shapes=(pb, 128))


def test_graph_from_numpy_carries_a_pb_128_twin():
    """A reference graph built at PB 128 crosses ``convert`` with its
    blocked twin as it is, and the port's ``"cuda"`` sweep on it equals
    the flat one."""
    ref_spec, _ = ref_models.hpc_benchmark(scale=0.02)
    [rg] = ref_builder.build_shards(
        ref_spec, ref_builder.decompose(ref_spec, 1),
        block_shapes=(128, 4096))
    g = convert.graph_from_numpy(
        {f.name: getattr(rg, f.name) for f in dataclasses.fields(rg)})
    assert (g.blocked.pb, g.blocked.eb) == (128, 4096)
    _assert_blocked_equal(g.blocked, rg.blocked, "convert")
    g = g.to(CPU)
    ring = torch.from_numpy((np.random.default_rng(3).uniform(
        size=(g.max_delay, g.n_mirror)) < 0.2).astype(np.float32))
    t = torch.tensor(9, dtype=torch.int32)
    ex_f, in_f, a_f = engine.synaptic_sweep(g, g.weight_init, ring, t)
    ex_c, in_c, a_c = engine.synaptic_sweep(g, g.weight_init, ring, t,
                                            mode="cuda")
    assert backends.get_backend("cuda").prepare(g).blocked.pb == 128
    torch.testing.assert_close(ex_c, ex_f, rtol=0, atol=1e-3)
    torch.testing.assert_close(in_c, in_f, rtol=0, atol=1e-3)
    assert torch.equal(a_c, a_f)


# --------------------------------------------------------------------------
# the backends: "cuda:auto", block_shapes=
# --------------------------------------------------------------------------

def _small_spec(b, dec, s):
    """The reference's ``pallas:auto`` test network, built from a given
    package's modules."""
    ne, ni = 20, 8
    area = dec.AreaSpec("a", ne + ni, positions=np.zeros((ne + ni, 3)))
    exc = s.LIFParams(i_e=800.0, t_ref=1.0)
    inh = s.LIFParams(i_e=800.0, t_ref=1.0, tau_m=8.0)
    return b.NetworkSpec(
        areas=[area], groups=[exc, inh],
        populations=[b.Population("E", 0, 0, ne),
                     b.Population("I", 0, 1, ni)],
        projections=[
            b.Projection(0, 0, 4, 45.0, 5.0, 1, 4, channel=0, plastic=True),
            b.Projection(1, 0, 3, -200.0, 10.0, 1, 3, channel=1)],
        max_delay=6, seed=5)


def test_cuda_auto_matches_reference_pallas_auto_and_cuda():
    """``"cuda:auto"`` resolves outside the registry, once; over 120 STDP
    steps it gives the reference's ``"pallas:auto"`` spikes with weights
    within 1e-4, and the port's ``"cuda"`` run bit for bit (the relayout
    keeps each row's runs in flat order)."""
    before = backends.available_backends()
    b = backends.get_backend("cuda:auto")
    assert b is backends.get_backend("cuda:auto")
    assert b.block_shapes == "auto" and b.weights_layout == "blocked"
    assert backends.available_backends() == before

    ref_spec = _small_spec(ref_builder, ref_decomposition, ref_snn)
    gd = ref_builder.build_shards(
        ref_spec, ref_builder.decompose(ref_spec, 1))[0].device_arrays()
    ref_table = ref_snn.make_param_table(list(ref_spec.groups), dt=0.1)
    cfg_ref = ref_engine.EngineConfig(dt=0.1, stdp=ref_models.HPC_STDP,
                                      sweep="pallas:auto",
                                      external_drive=False)
    st_ref = ref_engine.init_state(gd, list(ref_spec.groups),
                                   jax.random.key(0), sweep="pallas:auto")
    fin_ref, sp_ref = jax.jit(
        lambda s: ref_engine.run(s, gd, ref_table, cfg_ref, 120))(st_ref)
    sp_ref = np.asarray(sp_ref)

    spec = _small_spec(builder, decomposition, snn)
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(CPU)
    table = snn.make_param_table(list(spec.groups), 0.1, device=CPU)
    out = {}
    for sweep in ("cuda", "cuda:auto"):
        cfg = engine.EngineConfig(dt=0.1, stdp=models.HPC_STDP, sweep=sweep,
                                  external_drive=False)
        st = engine.init_state(g, list(spec.groups), 0, sweep=sweep,
                               device=CPU)
        out[sweep] = engine.run(st, g, table, cfg, 120, device=CPU)
    lay = b.prepare(g)
    assert lay is b.prepare(g)                       # relaid out once
    assert (lay.blocked.pb, lay.blocked.eb) == \
        autotune.autotune_block_shapes(g).as_tuple()
    assert lay.blocked.pb != g.blocked.pb
    assert sp_ref.sum() > 10, "nothing spiked - vacuous"
    (fc, sc), (fa, sa) = out["cuda"], out["cuda:auto"]
    np.testing.assert_array_equal(sa.numpy(), sp_ref)
    np.testing.assert_allclose(fa.weights.numpy(),
                               np.asarray(fin_ref.weights), atol=1e-4)
    assert fa.weights_layout == "flat"
    assert torch.equal(sa, sc)
    for a, c in ((fa.weights, fc.weights), (fa.neurons.v_m, fc.neurons.v_m),
                 (fa.traces.k_pre, fc.traces.k_pre),
                 (fa.traces.k_post, fc.traces.k_post)):
        assert torch.equal(a, c)


def test_block_shapes_relayout_reuse_and_tags():
    """A prebuilt twin that satisfies the resolved shapes is reused; else
    the graph is laid out again once per graph; the gate takes the same
    spec; a state minted under another shape is refused."""
    spec, _ = models.hpc_benchmark(0.05)
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(CPU)
    bg = g.blocked
    same = backends.CudaBackend(block_shapes=(bg.pb, 128))
    assert same.prepare(g).blocked is bg
    pinned = backends.CudaBackend(block_shapes=(128, 128))
    lay = pinned.prepare(g)
    assert lay.blocked.pb == 128 and lay.blocked.eb >= 128
    assert lay.blocked.weight is None and lay.blocked.pre_idx.dtype == \
        torch.int32
    assert pinned.prepare(g, baked=True).blocked is bg
    host = builder.build_shards(spec, builder.decompose(spec, 1),
                                block_shapes=(128, lay.blocked.eb))[0]
    for f in ("pre_idx", "post_rel", "delay", "channel", "plastic",
              "edge_perm"):
        np.testing.assert_array_equal(getattr(lay.blocked, f).numpy(),
                                      getattr(host.blocked, f), f)
    gate = backends.CudaSparseBackend(block_shapes="auto")
    glay = gate.prepare(g)
    assert (glay.blocked.pb, glay.blocked.eb) == \
        autotune.autotune_block_shapes(g).as_tuple()
    assert glay.gate_index.shape == (glay.blocked.nb, glay.blocked.eb)

    table = snn.make_param_table(list(spec.groups), 0.1, device=CPU)
    st = engine.init_state(g, list(spec.groups), 0, sweep="cuda",
                           device=CPU)
    cfg = engine.EngineConfig(dt=0.1, external_drive=False, sweep=pinned)
    with pytest.raises(ValueError, match="block shapes"):
        engine.engine_step(st, g, table, cfg)
    with pytest.raises(ValueError, match="block_shapes"):
        backends.CudaBackend(block_shapes="fastest").prepare(g)


def test_stacked_step_keeps_baked_shapes_and_warns():
    """The stacked step runs the net's baked shapes: a backend-side spec
    on a net built without one warns; a tuned net stays silent."""
    spec, _ = models.hpc_benchmark(scale=0.02)
    dec = dist.mesh_decompose(spec, 1, 2)
    table = snn.make_param_table(list(spec.groups), 0.1, device=CPU)
    cfg = dist.DistributedConfig(engine=engine.EngineConfig(
        dt=0.1, sweep="cuda:auto", external_drive=False))
    plain = dist.prepare_stacked(spec, dec, 1, 2).to(CPU)
    with pytest.warns(UserWarning, match="baked block shapes"):
        step = dist.make_distributed_step(plain, table, cfg, device=CPU)
    assert all(lay.blocked.pb == plain.blocked_meta[2]
               for lay in step.layouts)
    tuned = dist.prepare_stacked(spec, dec, 1, 2, block_shapes="auto")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        dist.check_net_backend(tuned, cfg)
