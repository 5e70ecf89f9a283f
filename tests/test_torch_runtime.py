"""The port's fault-tolerant runtime on the CPU (``repro_torch.runtime``,
``distributed.advance_generators``, ``multihost.plan_elastic_mesh`` and the
launcher's supervised mode), held against the reference's
``repro.runtime`` where both run.

* fault specs: ``parse_specs`` equals the reference's on a list of
  strings; fire-once claims, env fallback, ``slow``, ``ckpt-corrupt``;
* heartbeat files, the restart policy's capped backoff, the monitor, the
  train supervisor;
* the in-process supervised engine: a kill at step 33 resumed from the
  step-30 checkpoint gives the reference's uninterrupted raster (drive
  off); with the drive on (and STDP, and a corrupted newest checkpoint
  walked past) it gives the port's own uninterrupted run bitwise - the
  generator leaf;
* ``advance_generators`` lands each shard's generator on the stream an
  uninterrupted run holds; ``plan_mesh`` equals the reference's;
* ``shrink_remap_state`` from 4x2 to 2x2 continues the 4x2 trajectory
  bitwise, and refuses STDP and materialized connectivity with the
  reference's messages;
* the gloo launcher: base, ``kill@70#1`` and ``kill@70#1 --elastic`` give
  equal global-order hashes; it aborts after ``--max-restarts``.
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from repro.core import builder as ref_builder
from repro.core import engine as ref_engine
from repro.core import models as ref_models
from repro.core import neuron_models as ref_neuron_models
from repro.runtime import elastic as ref_elastic
from repro.runtime import inject as ref_inject
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import backends, builder, engine, models, multihost
from repro_torch.core import distributed as dist
from repro_torch.core import neuron_models, snn
from repro_torch.launch import multihost as mh_launch
from repro_torch.runtime import elastic, inject
from repro_torch.runtime.fault import (HeartbeatMonitor, RestartPolicy,
                                       TrainSupervisor)
from repro_torch.runtime.inject import (ENV_VAR, FaultInjector, FaultSpec,
                                        SimulatedFault, parse_specs)
from repro_torch.runtime.supervisor import HeartbeatFile, SimulationSupervisor

CPU = "cpu"


# --------------------------------------------------------------------------
# fault specs and the injector
# --------------------------------------------------------------------------

SPEC_STRINGS = ["kill@70", "kill@70#1", "slow@10:5", "hang@40#2",
                " ckpt-corrupt@35 ", "kill@70#1, slow@10:2; hang@40",
                "ckpt-corrupt@1600,kill@1700", "slow@3:0.25#3;;", "", None]


@pytest.mark.parametrize("text", SPEC_STRINGS)
def test_parse_specs_equals_reference(text):
    got = parse_specs(text)
    want = ref_inject.parse_specs(text)
    assert [dataclasses.astuple(s) for s in got] == \
        [dataclasses.astuple(s) for s in want]
    assert [s.key for s in got] == [s.key for s in want]


@pytest.mark.parametrize("text", ["explode@3", "kill70", "kill@x",
                                  "slow@3:fast"])
def test_bad_specs_raise_as_the_reference(text):
    with pytest.raises(ValueError) as got:
        FaultSpec.parse(text)
    with pytest.raises(ValueError) as want:
        ref_inject.FaultSpec.parse(text)
    assert str(got.value) == str(want.value)


def test_cli_contract_equals_reference():
    assert (ENV_VAR, inject.KILL_EXIT_CODE, inject.KINDS) == (
        ref_inject.ENV_VAR, ref_inject.KILL_EXIT_CODE, ref_inject.KINDS)
    assert (ENV_VAR, inject.KILL_EXIT_CODE) == ("REPRO_FAULT_INJECT", 117)


def test_injector_rank_filter_and_fire_once():
    inj = FaultInjector(parse_specs("kill@5#1"), rank=0, mode="raise")
    inj.fire(5)                       # wrong rank: nothing happens
    inj = FaultInjector(parse_specs("kill@5"), rank=0, mode="raise")
    inj.fire(4)
    with pytest.raises(SimulatedFault):
        inj.fire(5)
    inj.fire(5)                       # in-memory claim: fires exactly once
    with pytest.raises(ValueError, match="raise"):
        FaultInjector((), mode="explode")


def test_injector_fire_once_across_instances(tmp_path):
    """A RESTARTED incarnation (a new injector on a shared state_dir) does
    not replay a fault already fired."""
    sd = str(tmp_path / "faults")
    first = FaultInjector(parse_specs("kill@5"), mode="raise", state_dir=sd)
    with pytest.raises(SimulatedFault):
        first.fire(5)
    second = FaultInjector(parse_specs("kill@5"), mode="raise", state_dir=sd)
    second.fire(5)
    assert os.path.exists(os.path.join(sd, "kill@5x1#0.fired"))


def test_injector_env_fallback(monkeypatch):
    monkeypatch.setenv(ENV_VAR, "slow@3:2")
    inj = FaultInjector.from_args(None, slow_unit_s=0.0)
    assert inj is not None and inj.specs[0].kind == "slow"
    monkeypatch.delenv(ENV_VAR)
    assert FaultInjector.from_args(None) is None


def test_injector_slow_returns_control():
    inj = FaultInjector(parse_specs("slow@2:3"), mode="raise",
                        slow_unit_s=0.01)
    t0 = time.monotonic()
    inj.fire(2)
    assert time.monotonic() - t0 >= 0.03


def test_injector_ckpt_corrupt(tmp_path):
    """ckpt-corrupt truncates the newest committed step's largest array;
    the manager's restore then falls back to the previous step."""
    tree = lambda v: {"w": torch.full((64,), v), "s": torch.tensor(int(v))}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree(1.0))
    mgr.save(2, tree(2.0))
    FaultInjector(parse_specs("ckpt-corrupt@0"), mode="raise",
                  ckpt_dir=str(tmp_path)).fire(0)
    restored, _ = mgr.restore(tree(0.0))
    assert int(restored["s"]) == 1


# --------------------------------------------------------------------------
# heartbeats, restart policy, monitor, train supervisor
# --------------------------------------------------------------------------

def test_heartbeat_file_beat_and_ages(tmp_path):
    d = str(tmp_path / "hb")
    hb0, hb2 = HeartbeatFile(d, 0), HeartbeatFile(d, 2)
    hb0.beat()
    hb2.beat()
    ages = HeartbeatFile.ages(d)
    assert set(ages) == {0, 2}
    assert all(0 <= a < 5.0 for a in ages.values())
    assert HeartbeatFile.ages(str(tmp_path / "missing")) == {}
    past = time.time() - 100.0
    os.utime(hb2.path, (past, past))
    assert HeartbeatFile.ages(d)[2] > 90.0


def test_restart_policy_backoff_cap():
    pol = RestartPolicy(max_restarts=5, backoff_s=1.0, backoff_mult=10.0,
                        backoff_cap_s=2.5)
    assert [pol.next_action()[1] for _ in range(3)] == [1.0, 2.5, 2.5]
    uncapped = RestartPolicy(max_restarts=5, backoff_s=1.0,
                             backoff_mult=10.0, backoff_cap_s=None)
    assert [uncapped.next_action()[1] for _ in range(3)] == [1.0, 10.0, 100.0]
    done = RestartPolicy(max_restarts=0)
    assert done.next_action() == ("abort", 0.0)


def test_heartbeat_monitor_stragglers_and_dead():
    mon = HeartbeatMonitor(4, straggler_factor=3.0)
    for step in range(8):
        for w in range(4):
            mon.observe(w, 1.0 if w != 2 else (1.0 if step < 7 else 5.0))
    assert mon.stragglers() == [2]
    mon = HeartbeatMonitor(3, timeout_s=0.01)
    now = time.monotonic()
    mon.observe(0, 1.0, now=now)
    mon.last_seen[1] = now - 10.0
    mon.observe(2, 1.0, now=now)
    assert mon.dead(now=now) == [1] and not mon.healthy(now=now)


def test_train_supervisor_recovers_and_records_backoff(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    fails = {7: True, 23: True}

    def injector(step):
        if fails.pop(step, False):
            raise RuntimeError("boom")

    sup = TrainSupervisor(mgr, save_every=5,
                          policy=RestartPolicy(max_restarts=3,
                                               backoff_s=0.001,
                                               backoff_cap_s=0.002))
    final, step = sup.run({"x": torch.tensor(0.0)},
                          lambda s, i: {"x": s["x"] + 1.0}, 30,
                          fail_injector=injector)
    # as the reference's: ``latest_step`` is read before ``restore``
    # drains the async save, so x may run ahead of the step count
    assert step == 30 and float(final["x"]) >= 30.0
    assert [e for e in sup.events if e.startswith("backoff@")] == [
        "backoff@7:0.001", "backoff@23:0.002"]
    assert len([e for e in sup.events
                if e.startswith(("restore@", "restart@"))]) == 2
    with pytest.raises(RuntimeError, match="exceeded max restarts"):
        TrainSupervisor(CheckpointManager(str(tmp_path / "abort")),
                        save_every=10, policy=RestartPolicy(
            max_restarts=1, backoff_s=0.001)).run(
            {"x": torch.tensor(0.0)}, lambda s, i: s, 10,
            fail_injector=lambda i: (_ for _ in ()).throw(RuntimeError()))


def test_simulation_supervisor_abort_path(tmp_path):
    mgr = CheckpointManager(str(tmp_path))

    def bad_step(state, i):
        raise RuntimeError("always failing")

    sup = SimulationSupervisor(
        mgr, save_every=10,
        policy=RestartPolicy(max_restarts=2, backoff_s=0.001,
                             backoff_cap_s=0.002),
        restore_fn=lambda s: (s, 0))
    with pytest.raises(RuntimeError, match="exceeded max restarts"):
        sup.run({"x": np.zeros(3)}, bad_step, 5)
    assert sup.delays == [0.001, 0.002]      # capped exponential, recorded


def test_simulation_supervisor_gang_mode_propagates():
    """Without restore_fn a failure escapes (the process dies and the gang
    launcher restarts it) - it is never swallowed."""
    sup = SimulationSupervisor(None, save_every=0, restore_fn=None)
    with pytest.raises(SimulatedFault):
        sup.run({}, lambda s, i: (_ for _ in ()).throw(SimulatedFault("x")),
                5)


# --------------------------------------------------------------------------
# the in-process supervised engine: bitwise resume
# --------------------------------------------------------------------------

class _Settled:
    """The injector, with the manager's in-flight save committed before a
    fault fires: ``ckpt-corrupt`` then always damages the newest save."""

    def __init__(self, inj, mgr):
        self.inj, self.mgr = inj, mgr

    def fire(self, step):
        if any(s.step == step for s in self.inj.specs):
            self.mgr.wait()
        self.inj.fire(step)


def _supervised(tmp_path, g, table, cfg, groups, n_steps, faults,
                save_every, seed=0):
    """``engine_step`` under SimulationSupervisor with an in-process
    ``restore_fn``: the raster (rows written by step index, so replays
    overwrite), the final state and the supervisor."""
    backend = backends.get_backend(cfg.sweep)
    layout = backend.prepare(g)
    model = neuron_models.get_model(cfg.neuron_model)
    s0 = engine.init_state(g, groups, seed, sweep=cfg.sweep, device=CPU)
    spikes = torch.zeros((n_steps, g.n_local), dtype=torch.bool)
    mgr = CheckpointManager(str(tmp_path), keep=3)

    def step_fn(st, i):
        st, spikes[i] = engine.engine_step(st, g, table, cfg,
                                           backend=backend, layout=layout,
                                           model=model)
        return st, None

    def restore_fn(_state):
        # structure from the initial state, values from the file
        restored, md = mgr.restore(s0)
        return restored, int(md["step"])

    sup = SimulationSupervisor(
        mgr, save_every=save_every,
        policy=RestartPolicy(max_restarts=3, backoff_s=0.001),
        injector=_Settled(FaultInjector(parse_specs(faults), mode="raise",
                                        ckpt_dir=str(tmp_path)), mgr),
        restore_fn=restore_fn)
    fin, end = sup.run(s0, step_fn, n_steps)
    assert end == n_steps
    return spikes, fin, sup


def test_supervised_resume_equals_reference_run(tmp_path):
    """kill@33 and kill@133 with saves every 10 steps: restored from steps
    30 and 130, the 150-step raster equals the reference's uninterrupted
    run (drive off) exactly, and ``v_m`` to 1e-4 (the port's twins round a
    multiply-add the reference's XLA contracts); ``v_m`` equals the port's
    own uninterrupted run bitwise.  The net first fires at step 63."""
    ref_spec, _ = ref_models.model_demo("lif", scale=0.02)
    g_ref = ref_builder.build_shards(
        ref_spec, ref_builder.decompose(ref_spec, 1))[0].device_arrays()
    ref_table = ref_neuron_models.get_model("lif").make_param_table(
        list(ref_spec.groups), dt=0.1)
    ref_cfg = ref_engine.EngineConfig(dt=0.1, external_drive=False)
    st = ref_engine.init_state(g_ref, list(ref_spec.groups),
                               jax.random.key(0))
    ref_fin, ref_bits = jax.jit(lambda s: ref_engine.run(
        s, g_ref, ref_table, ref_cfg, 150))(st)
    n = ref_spec.n_neurons
    ref_bits = np.asarray(ref_bits)[:, :n].astype(bool)
    assert ref_bits.sum() > 30, "vacuous test - nothing spiked"

    spec, _ = models.model_demo("lif", scale=0.02)
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(CPU)
    table = snn.make_param_table(list(spec.groups), 0.1, device=CPU)
    cfg = engine.EngineConfig(dt=0.1, external_drive=False, sweep="cuda")
    spikes, fin, sup = _supervised(tmp_path, g, table, cfg,
                                   list(spec.groups), 150,
                                   "kill@33,kill@133", 10)
    assert any(e.startswith("fail@33") for e in sup.events)
    assert "restore@30" in sup.events and "restore@130" in sup.events
    assert sup.delays == [pytest.approx(0.001), pytest.approx(0.002)]
    np.testing.assert_array_equal(spikes.numpy()[:, :n], ref_bits)
    np.testing.assert_allclose(fin.neurons.v_m.numpy()[:n],
                               np.asarray(ref_fin.neurons.v_m)[:n],
                               atol=1e-4)
    own, _ = engine.run(engine.init_state(g, list(spec.groups), 0,
                                          device=CPU), g, table, cfg, 150,
                        device=CPU)
    assert torch.equal(fin.neurons.v_m, own.neurons.v_m)


def _boosted_hpc(m, boost=2.0, **kw):
    spec, stdp = m.hpc_benchmark(scale=0.02, stdp=True)
    pops = [dataclasses.replace(p, ext_rate_hz=p.ext_rate_hz * boost)
            for p in spec.populations]
    return dataclasses.replace(spec, populations=pops, **kw), stdp


def test_supervised_resume_with_the_drive_on(tmp_path):
    """hpc_benchmark(0.02), drive on (boosted 2x), pl-STDP, the kernel
    backend's twins: a corrupted step-100 checkpoint and a kill at 123 walk
    back to step 50 and replay; raster, ``v_m``, weights and traces equal
    the uninterrupted run bitwise.  Only the checkpoint's generator leaf
    can put the drive's stream back."""
    spec, stdp = _boosted_hpc(models)
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(CPU)
    table = snn.make_param_table(list(spec.groups), 0.1, device=CPU)
    cfg = engine.EngineConfig(dt=0.1, stdp=stdp, sweep="cuda")
    spikes, fin, sup = _supervised(tmp_path, g, table, cfg,
                                   list(spec.groups), 160,
                                   "ckpt-corrupt@110,kill@123", 50)
    assert "restore@50" in sup.events, sup.events
    want, want_spikes = engine.run(
        engine.init_state(g, list(spec.groups), 0, device=CPU), g, table,
        cfg, 160, device=CPU)
    assert want_spikes.sum() > 30, "vacuous test - nothing spiked"
    assert torch.equal(spikes, want_spikes)
    flat = engine.state_with_weights_layout(fin, g, "flat")
    for a, b in ((flat.neurons.v_m, want.neurons.v_m),
                 (flat.weights, want.weights),
                 (fin.traces.k_post, want.traces.k_post),
                 (fin.ring, want.ring)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# generators, grids, elastic shrink
# --------------------------------------------------------------------------

def test_advance_generators_lands_on_the_run_stream():
    """Each shard's generator advanced by ``t`` draws of its rates equals
    the generator of a distributed run that stepped ``t`` times."""
    spec, _ = _boosted_hpc(models, connectivity="procedural")
    net = dist.prepare_stacked(spec, dist.mesh_decompose(spec, 2, 2), 2,
                               2).to(CPU)
    table = snn.make_param_table(list(spec.groups), 0.1, device=CPU)
    cfg = dist.DistributedConfig(engine=engine.EngineConfig(dt=0.1,
                                                            sweep="flat"))
    st = dist.init_stacked_state(net, list(spec.groups), 4, device=CPU)
    dist.run(st, net, table, cfg, 25, device=CPU)
    gens = dist.shard_generators(4, range(4), CPU)
    out = dist.advance_generators(gens, net.shard_graphs, 25, 0.1)
    assert out == gens
    for a, b in zip(gens, st.generators):
        assert torch.equal(a.get_state(), b.get_state())
    fresh = dist.shard_generators(4, range(4), CPU)
    assert not torch.equal(fresh[0].get_state(), gens[0].get_state())
    with pytest.raises(ValueError, match="generators"):
        dist.advance_generators(gens[:1], net.shard_graphs, 1)


@pytest.mark.parametrize("avail,width,pods", [
    (512, 16, True), (272, 16, True), (8, 16, True), (4, 2, False),
    (2, 2, False), (6, 2, False), (1, 2, False), (12, 4, True)])
def test_plan_mesh_equals_reference(avail, width, pods):
    got = elastic.plan_mesh(avail, model_width=width, prefer_pods=pods)
    want = ref_elastic.plan_mesh(avail, model_width=width, prefer_pods=pods)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_plan_elastic_mesh_one_process():
    """One process with 4 shards of width 2: a 2x2 grid; the plan's
    ``make_mesh`` gives the same grid."""
    mesh = multihost.plan_elastic_mesh(2, 4, device=CPU)
    assert mesh.grid.shape == (2, 2) and mesh.num_processes == 1
    plan = elastic.plan_mesh(4, model_width=2, prefer_pods=False)
    assert np.array_equal(plan.make_mesh(device=CPU).grid, mesh.grid)
    assert multihost.plan_elastic_mesh(4, 2, device=CPU).grid.shape == (1, 2)


def test_shrink_remap_state_continues_bitwise():
    """A snapshot written under 4x2, remapped onto 2x2 by
    ``shrink_remap_state``, continues the 4x2 trajectory bitwise (raster
    and ``v_m``): the lif demo net, procedural, its drive drawn at zero
    rates (the generators are advanced all the same)."""
    spec, _ = models.model_demo("lif", scale=0.02)
    spec = dataclasses.replace(spec, connectivity="procedural")
    groups = list(spec.groups)
    table = snn.make_param_table(groups, 0.1, device=CPU)
    cfg = dist.DistributedConfig(engine=engine.EngineConfig(dt=0.1,
                                                            sweep="cuda"))

    def setup(rows, width):
        dec = dist.mesh_decompose(spec, rows, width)
        return dec, dist.prepare_stacked(spec, dec, rows, width).to(CPU)

    dec4, net4 = setup(4, 2)
    fresh4 = lambda: dist.init_stacked_state(net4, groups, 0, device=CPU)
    ref_fin, ref_spikes = dist.run(fresh4(), net4, table, cfg, 120,
                                   device=CPU)
    ref = dist.global_spikes(ref_spikes, net4, spec.n_neurons)
    assert ref[60:].sum() > 0, "vacuous: no spikes in the compared window"
    mid, _ = dist.run(fresh4(), net4, table, cfg, 60, device=CPU)
    host = multihost.snapshot_host_state(mid)

    dec2, net2 = setup(2, 2)
    fields, carried = elastic.shrink_remap_state(
        spec, 0, host, step=60, old_n_rows=4, old_row_width=2,
        new_dec=dec2, new_net=net2, groups=groups, device=CPU)
    assert carried == {"wire_overflow": 0, "gate_overflow": 0}
    st2 = multihost.state_from_fields(fields, net2, device=CPU)
    assert int(st2.t[0]) == 60
    fin2, spikes2 = dist.run(st2, net2, table, cfg, 60, device=CPU)
    assert torch.equal(dist.global_spikes(spikes2, net2, spec.n_neurons),
                       ref[60:])
    v = lambda fin, net: mh_launch.global_state_order(
        fin.v_m.numpy(), fin.weights.numpy(),
        {k: np.asarray(net.graph[k].cpu()) for k in
         ("global_id", "post_idx", "delay")}, spec.n_neurons,
        spec.max_delay)
    got, want = v(fin2, net2), v(ref_fin, net4)
    np.testing.assert_array_equal(got["v_m"], want["v_m"])
    np.testing.assert_array_equal(got["weights"], want["weights"])


@pytest.mark.parametrize("stdp", [True, False])
def test_shrink_remap_refuses_as_the_reference(stdp):
    """STDP on, or materialized connectivity: the reference's refusals,
    word for word."""
    port_spec, _ = models.model_demo("lif", scale=0.004)
    ref_spec, _ = ref_models.model_demo("lif", scale=0.004)
    if stdp:
        port_spec = dataclasses.replace(port_spec,
                                        connectivity="procedural")
        ref_spec = dataclasses.replace(ref_spec, connectivity="procedural")
    kw = dict(step=0, old_n_rows=2, old_row_width=2, new_dec=None,
              new_net=None, groups=[], stdp_active=stdp)
    with pytest.raises(ValueError) as got:
        elastic.shrink_remap_state(port_spec, 0, {}, **kw)
    with pytest.raises(ValueError) as want:
        ref_elastic.shrink_remap_state(ref_spec, 0, {}, **kw)
    assert str(got.value) == str(want.value)
    assert ("stdp" if stdp else "procedural") in str(got.value)


# --------------------------------------------------------------------------
# the gang-supervised launcher on gloo
# --------------------------------------------------------------------------

def _launch_supervised(out, processes, *extra, steps=120, save_every=30):
    argv = ["--processes", str(processes), "--devices-per-process", "2",
            "--row-width", "2", "--steps", str(steps), "--scale", "0.02",
            "--model", "lif", "--no-stdp", "--connectivity", "procedural",
            "--device", CPU, "--sweep", "cuda", "--save-every",
            str(save_every), "--backoff", "0.05", "--out", str(out),
            "--timeout", "240", *extra]
    return mh_launch.run_launcher(mh_launch.build_parser().parse_args(argv))


LEGS = {"base": (), "kill": ("--fault-inject", "kill@70#1"),
        "elastic": ("--fault-inject", "kill@70#1", "--elastic")}


@pytest.fixture(scope="module")
def gang_legs(tmp_path_factory):
    """The three legs, launched together: 2 processes x 2 shards each."""
    out = tmp_path_factory.mktemp("gang")
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    with ThreadPoolExecutor(len(LEGS)) as pool:
        futures = {k: pool.submit(_launch_supervised, out / f"{k}.json", 2,
                                  *extra) for k, extra in LEGS.items()}
        return {k: f.result() for k, f in futures.items()}


def test_gang_base_leg(gang_legs):
    base = gang_legs["base"]
    assert base["supervised"] and base["hash_order"] == "global"
    assert base["spiked"] > 30, "vacuous test - nothing spiked"
    sup = base["supervision"]
    assert sup["restarts"] == 0 and sup["incarnations"] == 1
    assert base["ckpt_events"] == ["save@30", "save@60", "save@90",
                                   "save@120"]
    assert base["resumed_from"] is None
    assert all(p["steps_run"] == 120 for p in base["per_process"])
    # this worker's raster is the plain worker's: the same trajectory
    plain = mh_launch.run_launcher(mh_launch.build_parser().parse_args([
        "--processes", "1", "--devices-per-process", "4", "--row-width",
        "2", "--steps", "120", "--scale", "0.02", "--model", "lif",
        "--no-stdp", "--connectivity", "procedural", "--device", CPU,
        "--sweep", "cuda", "--out",
        os.path.join(os.path.dirname(base["arrays"]), "plain.json")]))
    for k in ("bits_sha256", "vm_sha256", "weights_sha256"):
        assert plain[k] == base[k], k


@pytest.mark.parametrize("leg", ["kill", "elastic"])
def test_gang_restart_is_bitwise(gang_legs, leg):
    """A kill of rank 1 at step 70: the gang restarts from the step-60
    checkpoint - on the same 2x2 grid, or with --elastic on one process
    (1x2) - and the global-order raster, ``v_m`` and weights hashes equal
    the base run's."""
    base, rec = gang_legs["base"], gang_legs[leg]
    for k in ("bits_sha256", "vm_sha256", "weights_sha256", "spiked"):
        assert rec[k] == base[k], k
    assert rec["resumed_from"] == 60 and rec["incarnation"] == 1
    sup = rec["supervision"]
    assert sup["restarts"] == 1 and sup["delays"] == [0.05]
    assert sup["per_incarnation"][0]["failed"] == [[1, "117"]]
    if leg == "kill":
        assert sup["tiers"] == {"same": 1, "shrink": 0}
        assert rec["processes"] == 2 and rec["n_rows"] == 2
    else:
        assert sup["tiers"] == {"same": 0, "shrink": 1}
        assert rec["processes"] == 1 and rec["n_rows"] == 1
        assert sup["processes_final"] == 1
        assert any(e.startswith("shrink:2->1(mesh 1x2)")
                   for e in sup["events"])
    assert [p["steps_run"] for p in rec["per_process"]] == \
        [60] * rec["processes"]
    assert rec["ckpt_events"] == ["save@90", "save@120"]


def test_gang_supervisor_aborts_after_max_restarts(tmp_path):
    """A fault in every incarnation exhausts the restart budget: the
    launcher aborts with the policy's message, it does not spin."""
    with pytest.raises(SystemExit, match="exceeded max restarts"):
        _launch_supervised(tmp_path / "abort.json", 1, "--max-restarts",
                           "1", "--fault-inject", "kill@15,kill@25",
                           steps=40, save_every=10)
