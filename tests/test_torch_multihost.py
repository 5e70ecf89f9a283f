"""The port's multi-host path (``repro_torch.core.multihost``,
``repro_torch.launch.multihost``) on the CPU with gloo, at small sizes.

* launch and identity: cluster-env detection (k8s-style, SLURM, absent),
  ``initialize`` as a no-op at one process and on an explicit backend;
* the host grid: a row never spans processes, each process owns one
  contiguous block of shards;
* the shard-local build at one process equals ``prepare_stacked``;
* two gloo processes, each building only its rows: the rows equal the
  global build's, the raster, ``v_m`` and weights equal the
  single-process stacked run bit for bit (drive on, two wire pairs), the
  raster with the drive off equals the reference's 1-shard raster, the
  snapshot equals the stacked state and restores it, and rows out of rank
  order are refused;
* the launcher at 1 and 2 processes gives equal hashes; a failing worker
  fails the launch (its supervised mode: ``tests/test_torch_runtime.py``).
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import dataclasses
import inspect
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
from repro_torch.core import distributed as dist
from repro_torch.core import engine, models, multihost, snn
from repro_torch.launch import multihost as mh_launch

CPU = "cpu"
SRC = str(Path(__file__).resolve().parents[1] / "src")
N_DRIVE = 150      # steps of the drive-on runs
N_EQUIV = 200      # steps of the drive-off run against the reference


# --------------------------------------------------------------------------
# launch and identity
# --------------------------------------------------------------------------

def test_detect_cluster_env_k8s_style():
    env = {"REPRO_COORD_ADDR": "head-0.svc:1234", "REPRO_NUM_PROC": "16",
           "REPRO_PROC_ID": "7"}
    assert multihost.detect_cluster_env(env) == dict(
        coordinator_address="head-0.svc:1234", num_processes=16,
        process_id=7)


def test_detect_cluster_env_slurm():
    env = {"SLURM_PROCID": "3", "SLURM_NTASKS": "8",
           "SLURM_STEP_NODELIST": "node[003-008,010]"}
    got = multihost.detect_cluster_env(env)
    assert got == dict(coordinator_address="node003:12321", num_processes=8,
                       process_id=3)
    env["REPRO_COORD_PORT"] = "999"
    assert multihost.detect_cluster_env(env)["coordinator_address"] == \
        "node003:999"
    for nodelist, first in (("nid001, nid002", "nid001"),
                            ("login1,nid[001-002]", "login1"),
                            ("nid[001-002,005],login1", "nid001")):
        env["SLURM_STEP_NODELIST"] = nodelist
        assert multihost.detect_cluster_env(env)[
            "coordinator_address"] == f"{first}:999"
    del env["SLURM_STEP_NODELIST"]
    env["SLURM_JOB_NODELIST"] = "fugaku[0007-0010]"
    assert multihost.detect_cluster_env(env)["coordinator_address"] == \
        "fugaku0007:999"
    env["REPRO_COORD_ADDR"] = "coord:1"      # k8s-style vars take precedence
    assert multihost.detect_cluster_env(env)["coordinator_address"] == \
        "coord:1"


def test_detect_cluster_env_absent_and_initialize_noop(monkeypatch):
    for var in ("REPRO_COORD_ADDR", "SLURM_PROCID", "SLURM_NTASKS",
                "SLURM_STEP_NODELIST", "SLURM_JOB_NODELIST"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.detect_cluster_env() is None
    assert multihost.initialize() is None
    assert multihost.initialize(num_processes=1, process_id=0) is None
    assert not torch.distributed.is_initialized()


def test_initialize_takes_the_env_and_an_explicit_backend(monkeypatch):
    """``initialize()`` adopts the detected env and joins on the backend
    it is given (a recorder stands in for the process group); beyond one
    process it never picks a backend itself."""
    monkeypatch.setenv("SLURM_PROCID", "1")
    monkeypatch.setenv("SLURM_NTASKS", "4")
    monkeypatch.setenv("SLURM_STEP_NODELIST", "node[11-14]")
    seen = {}
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend,
                                                          **kw))
    with pytest.raises(ValueError, match="backend"):
        multihost.initialize()
    assert multihost.initialize(backend="gloo") == "gloo"
    assert seen == dict(backend="gloo", init_method="tcp://node11:12321",
                        world_size=4, rank=1)


def test_default_backend(monkeypatch):
    """gloo on the CPU and when processes share a card, nccl when each has
    its own."""
    assert multihost.default_backend("cpu", 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert multihost.default_backend("cuda", 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert multihost.default_backend("cuda", 2) == "nccl"


# --------------------------------------------------------------------------
# the host grid
# --------------------------------------------------------------------------

def test_make_host_mesh_rejects_a_row_spanning_processes(monkeypatch):
    monkeypatch.setattr(multihost, "_world", lambda: (2, 0))
    with pytest.raises(ValueError, match="span processes"):
        multihost.make_host_mesh(3, 2, device=CPU)


def test_local_shard_slice_is_contiguous(monkeypatch):
    for pid, want in ((0, (0, 4)), (1, (4, 8))):
        monkeypatch.setattr(multihost, "_world", lambda pid=pid: (2, pid))
        mesh = multihost.make_host_mesh(4, 2, device=CPU)
        assert mesh.row_process == (0, 0, 1, 1)
        sl = multihost.local_shard_slice(mesh)
        assert (sl.start, sl.stop) == want
        topo = multihost.host_topology(mesh)
        assert (topo.n_shards, topo.rows_per_host, topo.process_id) == \
            (8, 2, pid)
    torn = dataclasses.replace(mesh, row_process=(0, 1, 0, 1))
    with pytest.raises(ValueError, match="not contiguous"):
        multihost.local_shard_slice(torn)


def test_make_host_mesh_single_process():
    mesh = multihost.make_host_mesh(4, 2, device=CPU)
    assert mesh.num_processes == 1 and set(mesh.row_process) == {0}
    assert multihost.local_shard_slice(mesh) == slice(0, 8)
    assert mesh.device == torch.device(CPU)
    np.testing.assert_array_equal(mesh.grid, np.arange(8).reshape(4, 2))


# --------------------------------------------------------------------------
# the shard-local build at one process
# --------------------------------------------------------------------------

def _assert_rows_equal(local, glob):
    for f in ("n_shards", "row_width", "n_local", "n_mirror", "n_edges",
              "b_pad", "max_delay", "blocked_meta"):
        assert getattr(local, f) == getattr(glob, f), f
    assert sorted(local.graph) == sorted(glob.graph)
    assert mh_launch.net_field_hashes(local) == mh_launch.net_field_hashes(
        glob.select_shards(*local.local_slice))


@pytest.mark.parametrize("with_blocked", [True, False])
def test_prepare_stacked_local_matches_global(with_blocked):
    """One process owning the whole grid assembles, from the shard-local
    protocol (analytic dims + gid-table gather), exactly the net
    ``prepare_stacked`` builds: arrays, boundary tables (the gid tables'
    boundary lists equal the ``used``-filtered ones) and mirror
    metadata; and the reference's."""
    spec, _ = models.brunel(scale=0.02)
    spec = dataclasses.replace(spec, connectivity="procedural")
    dec = dist.mesh_decompose(spec, 4, 2)
    glob = dist.prepare_stacked(spec, dec, 4, 2, with_blocked=with_blocked)
    local = multihost.prepare_stacked_local(
        spec, dec, 4, 2, multihost.make_host_mesh(4, 2, device=CPU),
        with_blocked=with_blocked)
    assert local.local_slice == (0, 8)
    _assert_rows_equal(local, glob)
    ref_spec, _ = ref_models.brunel(scale=0.02)
    ref_spec = dataclasses.replace(ref_spec, connectivity="procedural")
    ref = ref_dist.prepare_stacked(ref_spec, ref_dist.mesh_decompose(
        ref_spec, 4, 2), 4, 2, with_blocked=with_blocked)
    np.testing.assert_array_equal(local.boundary_slots, ref.boundary_slots)
    materialized = dataclasses.replace(spec, connectivity="materialized")
    with pytest.raises(ValueError, match="procedural"):
        multihost.prepare_stacked_local(
            materialized, dec, 4, 2,
            multihost.make_host_mesh(4, 2, device=CPU))


# --------------------------------------------------------------------------
# two gloo processes, each building only its rows
# --------------------------------------------------------------------------

def _drive_spec(m):
    """hpc_benchmark(0.02) procedural with its Poisson drive boosted 2x:
    desynchronised and firing."""
    spec, stdp = m.hpc_benchmark(scale=0.02, stdp=True)
    pops = [dataclasses.replace(p, ext_rate_hz=p.ext_rate_hz * 2.0)
            for p in spec.populations]
    return dataclasses.replace(spec, populations=pops,
                               connectivity="procedural"), stdp


def _equiv_spec(m):
    """The distributed EQUIV spec, procedural: hpc_benchmark(0.02) with
    the constant drive i_e = 800 pA, run with the Poisson drive off."""
    spec, stdp = m.hpc_benchmark(scale=0.02, stdp=True)
    return dataclasses.replace(
        spec, groups=[dataclasses.replace(spec.groups[0], i_e=800.0)],
        connectivity="procedural"), stdp


WIRES = {"packed": None, "packed+sparse": "sparse"}

MH_CODE = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import torch
    from repro_torch.core import distributed as dist
    from repro_torch.core import engine, models, multihost
    from repro_torch.launch.multihost import net_field_hashes

    rank, addr, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    assert multihost.initialize(coordinator_address=addr, num_processes=2,
                                process_id=rank, backend="gloo") == "gloo"
    exec(sys.argv[4])                      # _drive_spec, _equiv_spec, WIRES

    def local_net(spec):
        mesh = multihost.make_host_mesh(4, 2, device="cpu")
        host = multihost.prepare_stacked_local(
            spec, dist.mesh_decompose(spec, 4, 2), 4, 2, mesh)
        return host, host.to("cpu")

    def gathered(spikes):
        return multihost.replicate_to_host(
            spikes.transpose(0, 1).to(torch.uint8))

    res = {}
    spec, stdp = _drive_spec(models)
    host, net = local_net(spec)
    res["slice"] = list(host.local_slice)
    res["hashes"] = net_field_hashes(host)
    for name, rw in WIRES.items():
        cfg = dist.DistributedConfig(
            engine=engine.EngineConfig(dt=0.1, stdp=stdp, sweep="flat"),
            comm_mode="area", overlap=True, spike_wire="packed",
            spike_wire_remote=rw)
        step = multihost.make_multihost_step(net, spec.groups, cfg,
                                             device="cpu")
        st = multihost.init_multihost_state(net, spec.groups, 3,
                                            device="cpu")
        fin, spikes = step.run(st, %(n_drive)d)
        snap = multihost.snapshot_host_state(fin)
        sp = gathered(spikes)
        # the snapshot restores: 10 more steps from it equal 10 more
        # steps from the state itself
        back = multihost.state_from_fields(snap, net, device="cpu")
        _, a = step.run(fin, 10)
        _, b = step.run(back, 10)
        res[name] = dict(restored=bool(torch.equal(a, b)),
                         overflow=int(fin.wire_overflow.sum()))
        if rank == 0:
            np.savez(f"{out}/{name}.npz", spikes=sp, **{
                k: v for k, v in snap.items() if k != "aux"})
    # rows out of rank order: each process handed the other's range
    other = (4, 8) if rank == 0 else (0, 4)
    try:
        dist.HostExchange(dataclasses.replace(net, local_slice=other), cfg)
        res["order_refused"] = False
    except ValueError as e:
        res["order_refused"] = "process-major" in str(e)

    spec, stdp = _equiv_spec(models)
    host, net = local_net(spec)
    cfg = dist.DistributedConfig(engine=engine.EngineConfig(
        dt=0.1, stdp=stdp, sweep="cuda", external_drive=False))
    step = multihost.make_multihost_step(net, spec.groups, cfg,
                                         device="cpu")
    st = multihost.init_multihost_state(net, spec.groups, 0, sweep="cuda",
                                        device="cpu")
    fin, spikes = step.run(st, %(n_equiv)d)
    sp = gathered(spikes)
    gid = multihost.replicate_to_host(host.graph["global_id"])
    if rank == 0:
        np.savez(f"{out}/equiv.npz", spikes=sp, global_id=gid)
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()
""") % {"n_drive": N_DRIVE, "n_equiv": N_EQUIV}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    """Run MH_CODE in two gloo processes; their records and saved arrays."""
    out = tmp_path_factory.mktemp("mh")
    addr = f"127.0.0.1:{_free_port()}"
    helpers = (f"WIRES = {WIRES!r}\n" + inspect.getsource(_drive_spec)
               + inspect.getsource(_equiv_spec))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", MH_CODE, str(r), addr, str(out), helpers],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    return out, [json.loads((out / f"rank{r}.json").read_text())
                 for r in range(2)]


@pytest.fixture(scope="module")
def stacked_runs():
    """The single-process stacked run of the drive-on spec (every shard
    in one process, ``StackedExchange``), per wire pair."""
    spec, stdp = _drive_spec(models)
    net = dist.prepare_stacked(spec, dist.mesh_decompose(spec, 4, 2), 4,
                               2).to(CPU)
    table = snn.make_param_table(list(spec.groups), 0.1, device=CPU)
    runs = {}
    for name, rw in WIRES.items():
        cfg = dist.DistributedConfig(
            engine=engine.EngineConfig(dt=0.1, stdp=stdp, sweep="flat"),
            comm_mode="area", overlap=True, spike_wire="packed",
            spike_wire_remote=rw)
        st = dist.init_stacked_state(net, list(spec.groups), seed=3,
                                     device=CPU)
        runs[name] = dist.run(st, net, table, cfg, N_DRIVE, device=CPU)
    return net, runs


def test_two_processes_build_their_rows(two_processes):
    """Each process holds its own two rows (shards 0-3, 4-7), equal field
    for field to those rows of the global build: the pads, blocked shape
    and boundary tables agree across processes."""
    _, ranks = two_processes
    spec, _ = _drive_spec(models)
    glob = dist.prepare_stacked(spec, dist.mesh_decompose(spec, 4, 2), 4, 2)
    for r, rec in enumerate(ranks):
        assert rec["slice"] == [4 * r, 4 * r + 4]
        assert rec["hashes"] == mh_launch.net_field_hashes(
            glob.select_shards(4 * r, 4 * r + 4))


@pytest.mark.parametrize("wire", list(WIRES))
def test_two_processes_equal_stacked_run(two_processes, stacked_runs, wire):
    """Two processes, each drawing its shards' drive from their own
    generators, give the single-process stacked run's raster, final
    ``v_m`` and weights bit for bit (packed, and packed intra + sparse
    remote), with no overflow."""
    out, ranks = two_processes
    _, runs = stacked_runs
    fin, spikes = runs[wire]
    assert spikes.sum() > 100, "vacuous - nothing spiked"
    got = np.load(out / f"{wire}.npz")
    np.testing.assert_array_equal(got["spikes"].transpose(1, 0, 2),
                                  spikes.numpy())
    for leaf in ("v_m", "weights"):
        np.testing.assert_array_equal(got[leaf], getattr(fin, leaf).numpy())
    assert all(rec[wire]["overflow"] == 0 for rec in ranks)


@pytest.mark.parametrize("wire", list(WIRES))
def test_snapshot_host_state_equals_stacked_state(two_processes,
                                                  stacked_runs, wire):
    """The two processes' snapshot holds every leaf and generator of the
    stacked run's final state, and restores a state that steps on as the
    original does."""
    out, ranks = two_processes
    _, runs = stacked_runs
    fin, _ = runs[wire]
    got = np.load(out / f"{wire}.npz")
    for f in dataclasses.fields(fin):
        v = getattr(fin, f.name)
        if isinstance(v, torch.Tensor):
            np.testing.assert_array_equal(got[f.name], v.numpy(), f.name)
    np.testing.assert_array_equal(
        got["generators"], torch.stack([g.get_state()
                                        for g in fin.generators]).numpy())
    assert all(rec[wire]["restored"] for rec in ranks)


def test_two_processes_equal_reference_single_shard(two_processes):
    """With the drive off, two processes on the kernel backend's twins
    give the reference's 1-shard raster of the same procedural net (the
    distributed EQUIV case)."""
    out, _ = two_processes
    ref_spec, ref_stdp = _equiv_spec(ref_models)
    g1 = ref_builder.build_shards(ref_spec,
                                  ref_builder.decompose(ref_spec, 1))[0]
    g1 = g1.device_arrays()
    table = ref_neuron_models.get_model("lif").make_param_table(
        list(ref_spec.groups), dt=0.1)
    cfg = ref_engine.EngineConfig(dt=0.1, stdp=ref_stdp,
                                  external_drive=False)
    st = ref_engine.init_state(g1, list(ref_spec.groups), jax.random.key(0))
    _, ref = jax.jit(lambda s: ref_engine.run(s, g1, table, cfg,
                                              N_EQUIV))(st)
    ref = np.asarray(ref)[:, :ref_spec.n_neurons].astype(bool)
    assert ref.sum() > 100, "vacuous test - nothing spiked"
    got = np.load(out / "equiv.npz")
    spikes, gid = got["spikes"].transpose(1, 0, 2).astype(bool), \
        got["global_id"]
    raster = np.zeros_like(ref)
    raster[:, gid[gid >= 0]] = spikes[:, gid >= 0]
    np.testing.assert_array_equal(raster, ref)


def test_host_exchange_refuses_rows_out_of_rank_order(two_processes):
    """The world gather concatenates by rank: a process handed the other
    process's rows is refused, on both processes."""
    _, ranks = two_processes
    assert [rec["order_refused"] for rec in ranks] == [True, True]


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def _launch(out, processes, *extra):
    argv = ["--processes", str(processes),
            "--devices-per-process", str(8 // processes), "--row-width",
            "2", "--steps", "120", "--device", CPU, "--sweep", "flat",
            "--out", str(out), "--timeout", "120", *extra]
    return mh_launch.run_launcher(mh_launch.build_parser().parse_args(argv))


@pytest.mark.parametrize("extra", [
    ("--connectivity", "procedural"),
    ("--connectivity", "materialized", "--wire-remote", "sparse"),
], ids=["procedural", "materialized-sparse"])
def test_run_launcher_one_and_two_processes_agree(tmp_path, monkeypatch,
                                                  extra):
    """1 process x 8 shards and 2 processes x 4 shards give equal hashes
    of the raster, ``v_m`` and weights; the record names the backend and
    each process's device, build seconds and RSS."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    one = _launch(tmp_path / "one.json", 1, *extra)
    two = _launch(tmp_path / "two.json", 2, *extra)
    assert one["spiked"] > 30, "vacuous test - nothing spiked"
    for k in ("bits_sha256", "vm_sha256", "weights_sha256", "spiked",
              "overflow", "n_rows", "wire_bytes_intra", "wire_bytes_inter"):
        assert one[k] == two[k], k
    assert (one["dist_backend"], two["dist_backend"]) == ("none", "gloo")
    assert [p["device"] for p in two["per_process"]] == [CPU, CPU]
    assert [p["shards"] for p in two["per_process"]] == [[0, 4], [4, 8]]
    assert all(p["host_build_s"] > 0 and p["peak_rss_during_build_bytes"]
               >= p["rss_before_build_bytes"] > 0 for p in two["per_process"])
    arrays = np.load(two["arrays"])
    assert arrays["raster"].sum() == two["spiked"]


def test_a_failing_worker_fails_the_launch(tmp_path):
    with pytest.raises(SystemExit, match="worker processes failed"):
        _launch(tmp_path / "bad.json", 2, "--scenario", "no_such_network")
