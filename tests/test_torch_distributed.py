"""Port distributed engine vs the reference's (``repro.core.distributed``).

* build: ``mesh_decompose`` and ``prepare_stacked`` equal the reference's
  field for field (hpc_benchmark with blocked arrays, marmoset under area
  and random mapping, a procedural spec);
* the reference's traffic-accounting tests, on the port's nets;
* EQUIV: stacked 4x2 runs (flat in every comm mode x overlap, the kernel
  backend's twins, the activity gate) give the reference's 1-shard raster;
  the per-model 2x2 runs likewise;
* WIRE: every codec gives the packed wire's raster on the port's own
  drive, and a starved wire reports its saturation; the per-tier overflow
  counts in closed form;
* the fused route with ``fresh``; the schedule of issue, sweep and wait;
  four gloo ranks equal to the stacked run; the state round trip.

Both packages start from the same state through ``repro_torch.convert``.
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import builder as ref_builder
from repro.core import distributed as ref_dist
from repro.core import engine as ref_engine
from repro.core import models as ref_models
from repro.core import neuron_models as ref_neuron_models
from repro_torch import convert
from repro_torch.core import backends, engine, models, neuron_models
from repro_torch.core import distributed as dist
from repro_torch.core import snn
from repro_torch.core import wire
from repro_torch.kernels import synaptic_gather as gather_mod
from repro_torch.kernels.lif_step import lif_step_plain
from repro_torch.kernels import adex_step, izhikevich_step

CPU = "cpu"
SRC = str(Path(__file__).resolve().parents[1] / "src")
N_EQUIV = 200


def _i_e_800(m):
    """The EQUIV spec of the reference's test: hpc_benchmark(0.02) with
    the constant drive i_e = 800 pA (a package's ``models`` module)."""
    spec, _ = m.hpc_benchmark(scale=0.02, stdp=True)
    return dataclasses.replace(
        spec, groups=[dataclasses.replace(spec.groups[0], i_e=800.0)])


def _boosted(m, factor):
    """hpc_benchmark(0.02) with the Poisson drive boosted ``factor`` x:
    desynchronised and firing (the reference's WIRE/OVERFLOW spec)."""
    spec, stdp = m.hpc_benchmark(scale=0.02, stdp=True)
    pops = [dataclasses.replace(p, ext_rate_hz=p.ext_rate_hz * factor)
            for p in spec.populations]
    return dataclasses.replace(spec, populations=pops), stdp


def _ref_raster(spec, model, stdp, n_steps):
    """The reference's 1-shard raster (flat, drive off, key 0)."""
    g1 = ref_builder.build_shards(spec, ref_builder.decompose(spec, 1))[0]
    g1 = g1.device_arrays()
    table = ref_neuron_models.get_model(model).make_param_table(
        list(spec.groups), dt=0.1)
    cfg = ref_engine.EngineConfig(dt=0.1, stdp=stdp, external_drive=False,
                                  neuron_model=model)
    st = ref_engine.init_state(g1, list(spec.groups), jax.random.key(0),
                               neuron_model=model)
    _, ref = jax.jit(lambda s: ref_engine.run(s, g1, table, cfg,
                                              n_steps))(st)
    return np.asarray(ref)[:, :spec.n_neurons].astype(bool)


def _ref_leaves(st):
    leaves = {k: np.asarray(getattr(st, k))
              for k in convert.DIST_STATE_LEAVES}
    leaves.update({f"aux.{k}": np.asarray(v) for k, v in st.aux.items()})
    return leaves


def _raster(spikes, net, n):
    return dist.global_spikes(spikes, net, n).numpy()


# --------------------------------------------------------------------------
# build
# --------------------------------------------------------------------------

def _specs(m, case):
    if case == "hpc":
        return m.hpc_benchmark(scale=0.02, stdp=True)[0], "area"
    if case == "procedural":
        spec = m.hpc_benchmark(scale=0.02, stdp=True)[0]
        return dataclasses.replace(spec, connectivity="procedural"), "area"
    spec = m.marmoset(scale=0.004, n_areas=4)
    return spec, case.split("-")[1]


def _assert_nets_equal(port, ref):
    for f in ("n_shards", "row_width", "n_local", "n_mirror", "n_edges",
              "b_pad", "max_delay"):
        assert getattr(port, f) == getattr(ref, f), f
    assert port.blocked_meta == (None if ref.blocked_meta is None
                                 else tuple(ref.blocked_meta))
    assert sorted(port.graph) == sorted(ref.graph)
    for k, v in ref.graph.items():
        assert port.graph[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(port.graph[k], np.asarray(v), k)
    for k in ("boundary_slots", "mirror_is_intra", "mirror_row_gather",
              "mirror_remote_gather", "mirror_src_flat"):
        np.testing.assert_array_equal(np.asarray(getattr(port, k)),
                                      np.asarray(getattr(ref, k)), k)


@pytest.mark.parametrize("case", ["hpc", "marmoset-area", "marmoset-random",
                                  "procedural"])
def test_build_matches_reference(case):
    """Every field of the decomposition and of the stacked net equals the
    reference's, bit for bit."""
    spec, method = _specs(models, case)
    ref_spec, _ = _specs(ref_models, case)
    dec = dist.mesh_decompose(spec, 4, 2, method=method)
    ref_dec = ref_dist.mesh_decompose(ref_spec, 4, 2, method=method)
    np.testing.assert_array_equal(dec.owner, ref_dec.owner)
    for a, b in zip(dec.parts, ref_dec.parts, strict=True):
        np.testing.assert_array_equal(a, b)
    with_blocked = case != "marmoset-random"
    net = dist.prepare_stacked(spec, dec, 4, 2, with_blocked=with_blocked)
    ref = ref_dist.prepare_stacked(ref_spec, ref_dec, 4, 2,
                                   with_blocked=with_blocked)
    _assert_nets_equal(net, ref)
    assert net.comm_bytes_area == ref.comm_bytes_area
    assert net.comm_bytes_global == ref.comm_bytes_global
    # and the reference's net carried across is the port's
    _assert_nets_equal(convert.stacked_net_from_numpy(ref), ref)


# --------------------------------------------------------------------------
# traffic accounting (the reference's non-slow tests, same numbers)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def marmoset_net():
    spec = models.marmoset(scale=0.004, n_areas=4)
    dec = dist.mesh_decompose(spec, n_rows=4, row_width=2)
    return dist.prepare_stacked(spec, dec, 4, 2, with_blocked=False)


def test_comm_accounting_area_beats_global(marmoset_net):
    net = marmoset_net
    assert net.comm_bytes_area < net.comm_bytes_global * 0.8, (
        net.comm_bytes_area, net.comm_bytes_global)


def test_boundary_sets_are_small(marmoset_net):
    net = marmoset_net
    assert net.b_pad < net.n_local * 0.7, (net.b_pad, net.n_local)


def test_boundary_pad_slots_do_not_alias_neuron_zero(marmoset_net):
    net = marmoset_net
    bs = np.asarray(net.boundary_slots)
    assert (bs <= net.n_local).all()
    assert (bs == net.n_local).any(), "config has no padding - vacuous"
    for s in range(net.n_shards):
        pads = bs[s] == net.n_local
        if pads.any():  # pads form a suffix after the real boundary prefix
            assert pads[int(np.argmax(pads)):].all()


def test_wire_bytes_through_codec(marmoset_net):
    net = marmoset_net
    for mode in ("area", "global"):
        for w in ("f32", "u8", "packed", "sparse"):
            got = dist.wire_bytes_per_step(net, mode, w)
            assert got == dist.wire_bytes_for_dims(
                mode, w, n_shards=net.n_shards, row_width=net.row_width,
                n_local=net.n_local, b_pad=net.b_pad)
        pw = wire.get_wire("packed")
        if mode == "global":
            expect = net.n_shards * pw.bytes_per_step(net.n_local)
        else:
            expect = (net.row_width * pw.bytes_per_step(net.n_local)
                      + net.n_shards * pw.bytes_per_step(net.b_pad))
        assert dist.wire_bytes_per_step(net, mode, "packed") == expect
    assert net.comm_bytes_area == dist.wire_bytes_per_step(net, "area", "f32")
    assert net.comm_bytes_global == dist.wire_bytes_per_step(net, "global",
                                                             "f32")


def test_sparse_wire_traffic_beats_packed_at_marmoset_dims():
    dims = dict(n_shards=256, row_width=16, n_local=4096, b_pad=640)
    for mode in ("area", "global"):
        sparse = dist.wire_bytes_for_dims(mode, "sparse", **dims)
        packed = dist.wire_bytes_for_dims(mode, "packed", **dims)
        assert sparse < packed, (mode, sparse, packed)
        assert sparse == ref_dist.wire_bytes_for_dims(mode, "sparse", **dims)
    area = [dist.wire_bytes_for_dims("area", w, **dims)
            for w in ("f32", "u8", "packed", "sparse")]
    assert area == sorted(area, reverse=True)


def test_wire_bytes_split_tiers():
    dims = dict(n_shards=8, row_width=2, n_local=4096, b_pad=640)
    for mode in ("area", "global"):
        s = dist.wire_bytes_split(mode, "packed", **dims)
        assert s["intra"] + s["inter"] == dist.wire_bytes_for_dims(
            mode, "packed", **dims)
    assert dist.wire_bytes_split("global", "packed", **dims)["intra"] == 0
    a = dist.wire_bytes_split("area", "packed", **dims)
    b = dist.wire_bytes_split("area", "packed", "sparse", **dims)
    assert b["intra"] == a["intra"] and b["inter"] != a["inter"]
    assert b["inter"] == 8 * wire.get_wire("sparse").bytes_per_step(640)
    g = dist.wire_bytes_split("global", "f32", "packed", **dims)
    assert g["inter"] == 8 * wire.get_wire("packed").bytes_per_step(4096)
    assert b == ref_dist.wire_bytes_split("area", "packed", "sparse", **dims)


# --------------------------------------------------------------------------
# EQUIV: stacked runs == the reference's 1-shard raster
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def equiv():
    """The reference's 1-shard raster and its stacked 4x2 net carried
    across, with the reference's initial distributed state."""
    ref_spec = _i_e_800(ref_models)
    raster = _ref_raster(ref_spec, "lif", ref_models.HPC_STDP, N_EQUIV)
    ref_dec = ref_dist.mesh_decompose(ref_spec, 4, 2)
    ref_net = ref_dist.prepare_stacked(ref_spec, ref_dec, 4, 2)
    leaves = _ref_leaves(ref_dist.init_stacked_state(
        ref_net, list(ref_spec.groups)))
    net = convert.stacked_net_from_numpy(ref_net).to(CPU)
    spec = _i_e_800(models)
    table = snn.make_param_table(list(spec.groups), 0.1, device=CPU)
    return dict(raster=raster, net=net, leaves=leaves, spec=spec,
                table=table)


EQUIV_COMBOS = ([("flat", m, o, True) for m in ("global", "area")
                 for o in (False, True)]
                + [("cuda", "area", True, True),
                   ("cuda", "global", False, False),
                   ("cuda:sparse", "area", True, True),
                   ("bucketed", "area", True, True)])


@pytest.mark.parametrize("sweep,mode,overlap,native", EQUIV_COMBOS)
def test_stacked_equals_reference_single_shard(equiv, sweep, mode, overlap,
                                               native):
    """Each combo's 4x2 raster equals the reference's 1-shard raster (the
    reference's ``test_distributed_equivalence_all_modes``); ``native``
    starts from blocked-resident weights, else from flat ones."""
    ref, net, spec = equiv["raster"], equiv["net"], equiv["spec"]
    assert ref.sum() > 100, "vacuous test - nothing spiked"
    cfg = dist.DistributedConfig(
        engine=engine.EngineConfig(dt=0.1, stdp=models.HPC_STDP,
                                   sweep=sweep, external_drive=False),
        comm_mode=mode, overlap=overlap)
    st = convert.dist_state_from_numpy(
        equiv["leaves"], net, sweep=sweep if native else None, device=CPU)
    assert st.weights_layout == (
        "flat" if not native or sweep in ("flat", "bucketed")
        else "blocked:256x640")
    fin, spikes = dist.run(st, net, equiv["table"], cfg, N_EQUIV,
                           device=CPU)
    np.testing.assert_array_equal(_raster(spikes, net, spec.n_neurons), ref)
    assert fin.weights_layout == "flat"
    assert fin.t.tolist() == [N_EQUIV] * net.n_shards
    assert int(fin.wire_overflow.sum()) == 0
    assert int(fin.gate_overflow.sum()) == 0


@pytest.mark.parametrize("sweep", ["flat", "cuda"])
@pytest.mark.parametrize("model", ["izhikevich", "adex"])
def test_stacked_per_model_equals_reference(model, sweep):
    """A 2x2 run of ``model_demo(model, 0.02)`` equals the reference's
    1-shard raster (the reference's
    ``test_distributed_two_rows_per_model``); on ``"cuda"`` the twin of
    K1 + K4 / K1 + K5 with ``fresh``."""
    n_steps = 120
    ref_spec, ref_stdp = ref_models.model_demo(model, scale=0.02, stdp=True)
    ref = _ref_raster(ref_spec, model, ref_stdp, n_steps)
    assert ref.sum() > 30, f"vacuous: {model} silent"
    spec, stdp = models.model_demo(model, scale=0.02, stdp=True)
    net = dist.prepare_stacked(spec, dist.mesh_decompose(spec, 2, 2),
                               2, 2).to(CPU)
    table = neuron_models.get_model(model).make_param_table(
        list(spec.groups), 0.1, device=CPU)
    cfg = dist.DistributedConfig(engine=engine.EngineConfig(
        dt=0.1, stdp=stdp, sweep=sweep, external_drive=False,
        neuron_model=model))
    st = dist.init_stacked_state(net, list(spec.groups), sweep=sweep,
                                 neuron_model=model, device=CPU)
    assert sorted(st.aux) == sorted(
        neuron_models.get_model(model).extra_fields)
    fin, spikes = dist.run(st, net, table, cfg, n_steps, device=CPU)
    np.testing.assert_array_equal(_raster(spikes, net, spec.n_neurons), ref)
    assert all(torch.isfinite(x).all() for x in fin.aux.values())


# --------------------------------------------------------------------------
# WIRE: every codec == packed on the port's own drive; overflow telemetry
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wire_net():
    spec, stdp = _boosted(models, 2.0)
    net = dist.prepare_stacked(spec, dist.mesh_decompose(spec, 4, 2), 4, 2,
                               with_blocked=False).to(CPU)
    table = snn.make_param_table(list(spec.groups), 0.1, device=CPU)
    return spec, stdp, net, table


def _wire_run(wire_net, mode, w, rw=None, n_steps=150):
    spec, stdp, net, table = wire_net
    cfg = dist.DistributedConfig(
        engine=engine.EngineConfig(dt=0.1, stdp=stdp, sweep="flat"),
        comm_mode=mode, spike_wire=w, spike_wire_remote=rw)
    st = dist.init_stacked_state(net, list(spec.groups), seed=0, device=CPU)
    fin, spikes = dist.run(st, net, table, cfg, n_steps, device=CPU)
    return spikes, int(fin.wire_overflow.sum())


@pytest.mark.parametrize("mode", ["area", "global"])
def test_every_wire_equals_packed(wire_net, mode):
    """The reference's ``test_cross_wire_trajectories_and_overflow_
    telemetry``: every lossless-at-this-rate codec gives the packed wire's
    raster with no overflow, the per-tier pair too; a starved sparse wire
    reports its saturation."""
    ref, ref_ov = _wire_run(wire_net, mode, "packed")
    assert ref.sum() > 100, "vacuous test - nothing spiked"
    assert ref_ov == 0
    for w, rw in (("f32", None), ("u8", None), ("sparse", None),
                  ("sparse:0.5", None), ("packed", "sparse")):
        spikes, ov = _wire_run(wire_net, mode, w, rw)
        assert torch.equal(spikes, ref), (mode, w, rw)
        assert ov == 0, (mode, w, rw)
    starved = wire.SparseWire(max_rate=0.0, min_capacity=1, name="tiny")
    _, ov = _wire_run(wire_net, mode, starved)
    assert ov > 0, "starved sparse wire saturated without telemetry"


def test_overflow_tier_accounting():
    """Part A of the reference's ``OVERFLOW_CODE``, in closed form: with a
    capacity-1 wire, all-ones bits saturate every local bitmap and each
    boundary payload with more than one live slot (area), the one gather
    of each shard (global); a single spike saturates nothing."""
    spec, _ = _boosted(models, 3.0)
    net = dist.prepare_stacked(spec, dist.mesh_decompose(spec, 4, 2), 4, 2,
                               with_blocked=False).to(CPU)
    tiny = wire.SparseWire(max_rate=0.0, min_capacity=1, name="tiny")
    bs = net.boundary_slots.numpy()
    real_b = (bs < net.n_local).sum(axis=1)
    assert real_b.max() > 1, "vacuous fixture: no boundary tier fires"
    ones = torch.ones((net.n_shards, net.n_local))
    single = torch.zeros_like(ones)
    single[:, 0] = 1.0

    def overflow_of(bits, mode):
        cfg = dist.DistributedConfig(engine=engine.EngineConfig(),
                                     comm_mode=mode, spike_wire=tiny)
        _, ov = dist._exchange(bits, dist.StackedExchange(net, cfg))
        return ov.tolist()

    assert overflow_of(ones, "area") == (1 + (real_b > 1)).tolist()
    assert overflow_of(ones, "global") == [1] * net.n_shards
    assert overflow_of(single, "area") == [0] * net.n_shards
    assert overflow_of(single, "global") == [0] * net.n_shards


# --------------------------------------------------------------------------
# fresh through the fused route
# --------------------------------------------------------------------------

@pytest.mark.parametrize("neuron", ["lif", "izhikevich", "adex"])
def test_fused_route_with_fresh_equals_composed(neuron):
    """``synaptic_gather_update(fresh=...)`` (the twin) == K1 with
    ``fresh``, + drive, then K2 / K4 / K5 (the twins), and the backend's
    fused ``sweep_update(fresh=...)`` == its composed route, ring
    included."""
    spec, _ = models.model_demo(neuron, scale=0.02)
    g = builder_shard(spec)
    model = neuron_models.get_model(neuron)
    table = model.make_param_table(list(spec.groups), 0.1, device=CPU)
    st = engine.init_state(g, list(spec.groups), 0, sweep="cuda",
                           neuron_model=neuron, device=CPU)
    rng = np.random.default_rng(5)
    ring = torch.from_numpy((rng.uniform(size=(g.max_delay, g.n_mirror))
                             < 0.3).astype(np.float32))
    fresh = torch.from_numpy((rng.uniform(size=g.n_mirror) < 0.3
                              ).astype(np.float32))
    drive = torch.from_numpy(rng.uniform(0, 50, g.n_local
                                         ).astype(np.float32))
    t = torch.tensor(7, dtype=torch.int32)
    bg = g.blocked
    names = gather_mod.NEURON_STATE[neuron][0]
    fields = {"v": st.neurons.v_m, "syn_ex": st.neurons.syn_ex,
              "syn_in": st.neurons.syn_in,
              "ref_count": st.neurons.ref_count, **st.neurons.extra}
    state = tuple(fields[k] for k in names)
    w2 = st.weights.reshape(bg.nb, bg.eb)
    arrived, out = gather_mod.synaptic_gather_update(
        bg.pre_idx, bg.post_rel, w2, bg.delay, bg.channel, ring, t, state,
        g.group_id, table, neuron=neuron, max_delay=g.max_delay, pb=bg.pb,
        drive=drive, fresh=fresh)
    i_ex, i_in, arr = gather_mod.synaptic_gather(
        bg.pre_idx, bg.post_rel, w2, bg.delay, bg.channel, ring, t,
        max_delay=g.max_delay, pb=bg.pb, fresh=fresh)
    n = g.n_local
    ex = i_ex[:n] + drive
    step = {"lif": lif_step_plain,
            "izhikevich": izhikevich_step.izhikevich_step,
            "adex": adex_step.adex_step}[neuron]
    want = step(*state, g.group_id, ex, i_in[:n], table)
    assert torch.equal(arrived, arr)
    assert (arr[bg.delay == 1] > 0).any(), "no fresh arrival - vacuous"
    for a, b in zip(out, want, strict=True):
        assert torch.equal(a, b)

    cb = backends.get_backend("cuda")
    lay = cb.prepare(g)
    assert cb.update_route(model, snn.SynapseModel.CURRENT_EXP) == \
        f"fused:{neuron}"
    fused = cb.sweep_update(lay, st.weights, ring, t, st.neurons, table,
                            drive, model=model, fresh=lambda: fresh)
    composed = backends.SweepBackend.sweep_update(
        cb, lay, st.weights, ring, t, st.neurons, table, drive, model=model,
        fresh=fresh)
    assert torch.equal(fused[3], composed[3])
    assert torch.equal(fused[3][6 % g.max_delay], fresh)   # slot t-1
    assert torch.equal(fused[1], composed[1])
    for name in ("v_m", "syn_ex", "syn_in", "ref_count", "spike"):
        assert torch.equal(getattr(fused[0], name),
                           getattr(composed[0], name)), name


def builder_shard(spec):
    from repro_torch.core import builder
    return builder.build_shards(spec, builder.decompose(spec, 1))[0].to(CPU)


# --------------------------------------------------------------------------
# the schedule: issue, delay>=2 pass, wait
# --------------------------------------------------------------------------

class _Recording(dist.StackedExchange):
    """A stacked exchange that logs its gathers and waits."""

    def __init__(self, net, cfg, log):
        super().__init__(net, cfg)
        self.log = log

    def _logged(self, what, handle):
        self.log.append(f"issue:{what}")
        wait = handle.wait

        def logged_wait():
            self.log.append("wait")
            return wait()
        handle.wait = logged_wait
        return handle

    def gather_world(self, payload):
        return self._logged("world", super().gather_world(payload))

    def gather_row(self, payload):
        return self._logged("row", super().gather_row(payload))


@pytest.mark.parametrize("sweep", ["flat", "cuda"])
def test_exchange_schedule(monkeypatch, sweep):
    """With overlap, both tiers are issued (the remote one first) before
    the flat backend's delay>=2 pass, and the wait comes after it; the
    ``"cuda"`` backend's one K1 launch comes after the wait, as
    documented.  Without overlap the wait precedes every sweep."""
    spec, stdp = _boosted(models, 2.0)
    net = dist.prepare_stacked(spec, dist.mesh_decompose(spec, 2, 2),
                               2, 2).to(CPU)
    table = snn.make_param_table(list(spec.groups), 0.1, device=CPU)
    log = []
    flat_arrivals = backends._flat_arrivals
    monkeypatch.setattr(backends, "_flat_arrivals",
                        lambda *a: log.append("sweep:old") or
                        flat_arrivals(*a))
    fused = backends.synaptic_gather_update
    monkeypatch.setattr(backends, "synaptic_gather_update",
                        lambda *a, **k: log.append("K1") or fused(*a, **k))
    for overlap in (True, False):
        cfg = dist.DistributedConfig(
            engine=engine.EngineConfig(dt=0.1, stdp=stdp, sweep=sweep),
            overlap=overlap, spike_wire="packed", spike_wire_remote="sparse")
        st = dist.init_stacked_state(net, list(spec.groups), device=CPU)
        log.clear()
        dist.run(st, net, table, cfg, 2, device=CPU,
                 exchange=_Recording(net, cfg, log))
        sweep_ev = "sweep:old" if sweep == "flat" else "K1"
        want = (["issue:world", "issue:row", sweep_ev, "wait", "wait"]
                if overlap and sweep == "flat" else
                ["issue:world", "issue:row", "wait", "wait", sweep_ev])
        want += [sweep_ev] * 3      # the other three shards
        assert log == want * 2, (overlap, log)


# --------------------------------------------------------------------------
# four gloo ranks == the stacked run
# --------------------------------------------------------------------------

GLOO_CODE = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import torch
    import torch.distributed as tdist
    from repro_torch.core import backends, engine, models, snn
    from repro_torch.core import distributed as dist

    rank, addr, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    tdist.init_process_group("gloo", init_method=addr, world_size=4,
                             rank=rank)
    spec, stdp = models.hpc_benchmark(scale=0.02, stdp=True)
    spec = dataclasses.replace(spec, populations=[
        dataclasses.replace(p, ext_rate_hz=p.ext_rate_hz * 2.0)
        for p in spec.populations])
    net = dist.prepare_stacked(spec, dist.mesh_decompose(spec, 2, 2), 2, 2,
                               with_blocked=False).to("cpu")
    table = snn.make_param_table(list(spec.groups), 0.1, device="cpu")
    log = []
    flat_arrivals = backends._flat_arrivals
    backends._flat_arrivals = (lambda *a: log.append("sweep:old")
                               or flat_arrivals(*a))

    class Recording(dist.ProcessGroupExchange):
        def _gather(self, payload, n, group):
            log.append("issue:" + ("world" if group is None else "row"))
            h = super()._gather(payload, n, group)
            wait = h.wait
            h.wait = lambda: log.append("wait") or wait()
            return h

    res = {}
    for mode, overlap in (("area", True), ("global", False)):
        cfg = dist.DistributedConfig(
            engine=engine.EngineConfig(dt=0.1, stdp=stdp, sweep="flat"),
            comm_mode=mode, overlap=overlap, spike_wire="packed",
            spike_wire_remote="sparse")
        st = dist.init_stacked_state(net, list(spec.groups), seed=3,
                                     shards=[rank], device="cpu")
        log.clear()
        fin, spikes = dist.run(st, net, table, cfg, 100, device="cpu",
                               exchange=Recording(net, cfg))
        np.save(f"{out}/{mode}-{rank}.npy", spikes.numpy())
        res[mode] = dict(log=log[:5], v_m=fin.v_m.numpy().tolist(),
                         overflow=int(fin.wire_overflow.sum()))
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump(res, f)
    tdist.destroy_process_group()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_gloo_ranks_equal_stacked_run(tmp_path):
    """Four gloo ranks (2x2, one shard each, ``ProcessGroupExchange``),
    each drawing its own shard's drive, give the stacked single-process
    run's raster and final ``v_m`` bit for bit in both comm modes; each
    rank issues both tiers before its delay>=2 pass and waits after it."""
    addr = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", GLOO_CODE, str(r), addr, str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    try:
        errs = [p.communicate(timeout=120)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]

    spec, stdp = _boosted(models, 2.0)
    net = dist.prepare_stacked(spec, dist.mesh_decompose(spec, 2, 2), 2, 2,
                               with_blocked=False).to(CPU)
    table = snn.make_param_table(list(spec.groups), 0.1, device=CPU)
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(4)]
    for mode, overlap in (("area", True), ("global", False)):
        cfg = dist.DistributedConfig(
            engine=engine.EngineConfig(dt=0.1, stdp=stdp, sweep="flat"),
            comm_mode=mode, overlap=overlap, spike_wire="packed",
            spike_wire_remote="sparse")
        st = dist.init_stacked_state(net, list(spec.groups), seed=3,
                                     device=CPU)
        fin, spikes = dist.run(st, net, table, cfg, 100, device=CPU)
        assert spikes.sum() > 50, "vacuous - nothing spiked"
        for r in range(4):
            got = np.load(tmp_path / f"{mode}-{r}.npy")
            np.testing.assert_array_equal(got[:, 0], spikes[:, r].numpy())
            np.testing.assert_array_equal(
                np.asarray(ranks[r][mode]["v_m"], np.float32)[0],
                fin.v_m[r].numpy())
            assert ranks[r][mode]["overflow"] == 0
            log = ranks[r][mode]["log"]
            if overlap:
                assert log == ["issue:world", "issue:row", "sweep:old",
                               "wait", "wait"], log
            else:
                assert log[:2] == ["issue:world", "wait"], log


# --------------------------------------------------------------------------
# state round trip
# --------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["lif", "izhikevich"])
def test_dist_state_round_trip(model):
    """The reference's initial distributed state -> the port (blocked
    weights) -> numpy gives the same leaves; a stepped port state -> numpy
    -> port -> numpy too."""
    ref_spec, _ = ref_models.model_demo(model, scale=0.02)
    ref_net = ref_dist.prepare_stacked(
        ref_spec, ref_dist.mesh_decompose(ref_spec, 2, 2), 2, 2)
    leaves = _ref_leaves(ref_dist.init_stacked_state(
        ref_net, list(ref_spec.groups), neuron_model=model))
    assert sorted(leaves) == sorted(convert.dist_state_leaves(model))
    net = convert.stacked_net_from_numpy(ref_net).to(CPU)
    st = convert.dist_state_from_numpy(leaves, net, sweep="cuda",
                                       neuron_model=model, device=CPU)
    assert st.weights_layout.startswith("blocked:")
    back = convert.dist_state_to_numpy(st, net)
    for k, v in leaves.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, k)

    spec, _ = models.model_demo(model, scale=0.02)
    table = neuron_models.get_model(model).make_param_table(
        list(spec.groups), 0.1, device=CPU)
    cfg = dist.DistributedConfig(engine=engine.EngineConfig(
        stdp=models.HPC_STDP, neuron_model=model))
    fin, spikes = dist.run(st, net, table, cfg, 20, device=CPU)
    a = convert.dist_state_to_numpy(fin, net)
    b = convert.dist_state_to_numpy(convert.dist_state_from_numpy(
        a, net, neuron_model=model, device=CPU), net)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], k)
    # one step at a time through the step object: the same run, the
    # state kept in its (blocked) layout
    step = dist.make_distributed_step(net, table, cfg, device=CPU)
    s = convert.dist_state_from_numpy(leaves, net, sweep="cuda",
                                      neuron_model=model, device=CPU)
    bits = []
    for _ in range(20):
        s, b_ = step(s)
        bits.append(b_)
    assert s.weights_layout == st.weights_layout
    assert torch.equal(torch.stack(bits), spikes)
    c = convert.dist_state_to_numpy(s, net)
    for k in a:
        np.testing.assert_array_equal(c[k], a[k], k)


def test_entry_points_default_to_the_card():
    """Without ``device="cpu"`` the entry points ask for the card, and
    raise without one; a host net is refused."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    spec, _ = models.hpc_benchmark(0.02)
    net = dist.prepare_stacked(spec, dist.mesh_decompose(spec, 2, 1), 2, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        net.to()
    with pytest.raises(TypeError, match="host arrays"):
        dist.init_stacked_state(net, list(spec.groups), device=CPU)
    net = net.to(CPU)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dist.init_stacked_state(net, list(spec.groups))
    st = dist.init_stacked_state(net, list(spec.groups), device=CPU)
    table = snn.make_param_table(list(spec.groups), 0.1, device=CPU)
    cfg = dist.DistributedConfig(engine=engine.EngineConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dist.run(st, net, table, cfg, 1)
    # the raw step and the dry run's probe (the dry run's cells ask for
    # "meta" themselves)
    from repro_torch.launch import dryrun_snn
    from repro_torch.launch.mesh import make_test_mesh
    flat = dist.DistributedConfig(engine=engine.EngineConfig(sweep="flat"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dist.make_raw_distributed_step(
            make_test_mesh((2, 1)), list(spec.groups), flat,
            max_delay=net.max_delay, n_local=net.n_local,
            n_mirror=net.n_mirror)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_snn.measure_firing_rates(steps=1)


def test_multihost_entry_points_default_to_the_card(tmp_path):
    """The multi-host entry points ask for the card too: the step, the
    state and a worker without ``--device cpu`` raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.core import multihost
    from repro_torch.launch import multihost as mh_launch
    spec, _ = models.hpc_benchmark(0.02)
    net = dist.prepare_stacked(spec, dist.mesh_decompose(spec, 2, 1), 2,
                               1).to(CPU)
    cfg = dist.DistributedConfig(engine=engine.EngineConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost.make_multihost_step(net, list(spec.groups), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost.init_multihost_state(net, list(spec.groups))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost.make_host_mesh(2, 1)
    args = mh_launch.build_parser().parse_args(
        ["--processes", "1", "--devices-per-process", "2", "--row-width",
         "1", "--steps", "1", "--process-id", "0",
         "--out", str(tmp_path / "mh.json")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mh_launch.run_worker(args)
    assert not (tmp_path / "mh.json").exists()
