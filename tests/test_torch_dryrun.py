"""The raw distributed step and the SNN dry run of the port
(``distributed.make_raw_distributed_step``, ``launch/dryrun_snn.py``,
``launch/mesh.py``, ``utils/op_costs.py``) against the net-facing step and
the reference's ``launch/dryrun_snn.py``.

* the raw step over a real net's consts (hpc(0.02), 4x2) equals
  ``make_distributed_step`` bitwise over 50 steps, on ``"flat"`` and the
  ``"cuda"`` twin, in both comm modes, overlap on and off, packed and
  sparse; compact consts equal int32 ones bitwise;
* its raster, and a shard's alone through the stand-in exchange, equal
  the reference's raw step (8 host devices, in a subprocess) bitwise;
* on ``meta`` at the reference test's dims the step runs (no host sync
  can), its gathered bytes equal the port's and the reference's
  ``wire_bytes_for_dims``, sparse < packed, and the crossover lies in
  (0.02, 1/32); every production cell meets its wire model;
* ``shard_dims`` and the probe's row partition equal the reference's
  (imported in a subprocess: ``repro.launch.dryrun_snn`` sets
  ``XLA_FLAGS`` at import), the probe's rate in a band around the
  reference probe's.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import distributed as ref_dist
from repro_torch.core import engine, models, snn
from repro_torch.core import distributed as dist
from repro_torch.launch import dryrun_snn
from repro_torch.launch.mesh import (MeshShape, make_production_mesh,
                                     make_test_mesh)
from repro_torch.utils.op_costs import OpCounter

CPU = "cpu"
SRC = str(Path(__file__).resolve().parents[1] / "src")
N_RAW = 50
PROBE_SEEDS = (0, 1, 2)


def _spec():
    """hpc_benchmark(0.02) with pl-STDP and i_e = 800 pA: fires from the
    first steps, with the Poisson drive on as well."""
    import dataclasses
    spec, stdp = models.hpc_benchmark(scale=0.02, stdp=True)
    return dataclasses.replace(spec, groups=[dataclasses.replace(
        spec.groups[0], i_e=800.0)]), stdp


@pytest.fixture(scope="module")
def raw_net():
    spec, stdp = _spec()
    net = dist.prepare_stacked(spec, dist.mesh_decompose(spec, 4, 2),
                               4, 2).to(CPU)
    table = snn.make_param_table(list(spec.groups), 0.1, device=CPU)
    return spec, stdp, net, table


def _compact(consts, n_mirror):
    """The consts in the dry run's compact dtypes."""
    idx_t = torch.uint16 if n_mirror <= 65535 else torch.int32
    narrow = dict(pre_idx=idx_t, post_idx=idx_t, mirror_src_idx=idx_t,
                  boundary_slots=idx_t, delay=torch.int8,
                  channel=torch.int8, blk_pre_idx=idx_t,
                  blk_post_rel=idx_t, blk_delay=torch.int8,
                  blk_channel=torch.int8)
    return {k: v.to(narrow[k]) if k in narrow else v
            for k, v in consts.items()}


RAW_COMBOS = [(sweep, mode, overlap, wire)
              for sweep in ("flat", "cuda") for mode in ("area", "global")
              for overlap in (False, True) for wire in ("packed", "sparse")]


@pytest.mark.parametrize("sweep,mode,overlap,wire", RAW_COMBOS)
def test_raw_step_equals_net_step(raw_net, sweep, mode, overlap, wire):
    """50 steps of the raw step over ``stacked_consts(net)`` give the
    net-facing step's raster and final state bitwise, from the same state
    (each shard's own drive generator); the compact consts give the same
    again."""
    spec, stdp, net, table = raw_net
    cfg = dist.DistributedConfig(
        engine=engine.EngineConfig(dt=0.1, stdp=stdp, sweep=sweep),
        comm_mode=mode, overlap=overlap, spike_wire=wire)
    blocked = sweep == "cuda"
    consts = dist.stacked_consts(net, needs_blocked=blocked)
    raw = dist.make_raw_distributed_step(
        make_test_mesh((4, 2)), list(spec.groups), cfg,
        max_delay=net.max_delay, n_local=net.n_local,
        n_mirror=net.n_mirror,
        blocked_meta=net.blocked_meta if blocked else None, device=CPU)
    runs = {}
    for name, fn in (
            ("net", lambda st: dist.run(st, net, table, cfg, N_RAW,
                                        device=CPU)),
            ("raw", lambda st: raw.run(st, consts, N_RAW)),
            ("compact", lambda st: raw.run(
                st, _compact(consts, net.n_mirror), N_RAW))):
        st = dist.init_stacked_state(net, list(spec.groups), seed=5,
                                     sweep=sweep, device=CPU)
        runs[name] = fn(st)
    f0, s0 = runs["net"]
    assert s0.sum() > 50, "vacuous - nothing spiked"
    for name in ("raw", "compact"):
        f1, s1 = runs[name]
        assert torch.equal(s0, s1), name
        for k in ("v_m", "syn_ex", "syn_in", "ref_count", "ring", "weights",
                  "k_pre", "k_post", "prev_bits", "t", "wire_overflow",
                  "gate_overflow"):
            assert torch.equal(getattr(f0, k), getattr(f1, k)), (name, k)


def test_raw_step_checks_its_consts(raw_net):
    """A call of the raw step is its binding's step; a blocked backend
    without ``blocked_meta`` raises the reference's ``ValueError``; a
    subset of shards without an exchange, a missing key and a wrong
    leading dim raise."""
    spec, stdp, net, table = raw_net
    cfg = dist.DistributedConfig(engine=engine.EngineConfig(
        dt=0.1, stdp=stdp, sweep="flat"))
    mesh = make_test_mesh((4, 2))
    kw = dict(max_delay=net.max_delay, n_local=net.n_local,
              n_mirror=net.n_mirror, device=CPU)
    raw = dist.make_raw_distributed_step(mesh, list(spec.groups), cfg, **kw)
    consts = dist.stacked_consts(net, needs_blocked=False)
    st = lambda: dist.init_stacked_state(net, list(spec.groups), seed=5,
                                         device=CPU)
    (f0, b0), (f1, b1) = raw(st(), consts), raw.bind(consts)(st())
    assert torch.equal(b0, b1) and torch.equal(f0.v_m, f1.v_m)
    with pytest.raises(ValueError, match="needs blocked_meta"):
        dist.make_raw_distributed_step(
            mesh, list(spec.groups), dist.DistributedConfig(
                engine=engine.EngineConfig(sweep="cuda")), **kw)
    with pytest.raises(ValueError, match="pass exchange="):
        dist.make_raw_distributed_step(mesh, list(spec.groups), cfg,
                                       shards=(2, 3), **kw).bind(
            {k: v[2:4] for k, v in consts.items()})
    with pytest.raises(ValueError, match="lack"):
        raw.bind({k: v for k, v in consts.items() if k != "delay"})
    with pytest.raises(ValueError, match="S_loc=8"):
        raw.bind({k: v[:2] for k, v in consts.items()})


def test_stand_in_exchange_bytes_equal_the_wire_model(raw_net):
    """One shard of the real net stepped alone through the stand-in: its
    gathers deliver ``wire_bytes_split``'s bytes by tier, in both modes
    and for a per-tier wire pair."""
    spec, stdp, net, table = raw_net
    consts = {k: v[3:4] for k, v in
              dist.stacked_consts(net, needs_blocked=False).items()}
    for mode, w, rw in (("area", "packed", None), ("area", "packed",
                                                   "sparse"),
                        ("global", "f32", None)):
        cfg = dist.DistributedConfig(
            engine=engine.EngineConfig(dt=0.1, stdp=stdp, sweep="flat"),
            comm_mode=mode, spike_wire=w, spike_wire_remote=rw)
        raw = dist.make_raw_distributed_step(
            make_test_mesh((4, 2)), list(spec.groups), cfg,
            max_delay=net.max_delay, n_local=net.n_local,
            n_mirror=net.n_mirror, shards=(3,),
            exchange=dist.StandInExchange, device=CPU)
        st = dist.init_stacked_state(net, list(spec.groups), shards=[3],
                                     device=CPU)
        bound = raw.bind(consts)
        fin, bits = bound(st)
        assert bits.shape == (1, net.n_local)
        got = bound.exchange.gathered_bytes
        want = dist.wire_bytes_split(mode, w, rw, n_shards=8, row_width=2,
                                     n_local=net.n_local, b_pad=net.b_pad)
        assert got == {"world": want["inter"], "row": want["intra"]}


# --------------------------------------------------------------------------
# the reference's raw step, on 8 host devices in a subprocess
# --------------------------------------------------------------------------

#: the shard whose consts and state every shard of the stand-in case holds
STAND_IN_SHARD = 3
#: steps of the reference comparison: with the drive off, i_e = 800 pA
#: first brings the neurons to threshold after about 63 steps
N_REF = 120

REF_RAW_CODE = textwrap.dedent(f"""
    import dataclasses, json
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.core import distributed as d, models
    from repro.core.engine import EngineConfig
    spec, stdp = models.hpc_benchmark(scale=0.02, stdp=True)
    spec = dataclasses.replace(spec, groups=[dataclasses.replace(
        spec.groups[0], i_e=800.0)])
    net = d.prepare_stacked(spec, d.mesh_decompose(spec, 4, 2), 4, 2)
    cfg = d.DistributedConfig(engine=EngineConfig(
        dt=0.1, stdp=stdp, external_drive=False))
    step = jax.jit(d.make_raw_distributed_step(
        jax.make_mesh((4, 2), ("data", "model")), list(spec.groups), cfg,
        max_delay=net.max_delay, n_local=net.n_local,
        n_mirror=net.n_mirror))
    consts = d.stacked_consts(net, needs_blocked=False)
    idx_t = np.uint16 if net.n_mirror <= 65535 else np.int32
    narrow = dict(pre_idx=idx_t, post_idx=idx_t, mirror_src_idx=idx_t,
                  boundary_slots=idx_t, delay=np.int8, channel=np.int8)
    compact = {{k: np.asarray(v).astype(narrow[k]) if k in narrow else v
               for k, v in consts.items()}}
    s = {STAND_IN_SHARD}
    one = {{k: np.repeat(np.asarray(v)[s:s + 1], 8, axis=0)
           for k, v in consts.items()}}
    st0 = d.init_stacked_state(net, list(spec.groups))
    st_one = jax.tree.map(lambda a: jnp.repeat(a[s:s + 1], 8, axis=0), st0)

    def run(c, st):
        c = {{k: jnp.asarray(v) for k, v in c.items()}}
        bits = []
        for _ in range({N_REF}):
            st, b = step(st, c)
            bits.append(np.asarray(b, bool))
        return np.stack(bits)

    out = dict(i32=run(consts, st0), compact=run(compact, st0),
               stand_in=run(one, st_one))
    print(json.dumps({{k: dict(shape=v.shape, bits=np.packbits(v).tobytes()
                                .hex()) for k, v in out.items()}}))
""")


@pytest.fixture(scope="module")
def reference_raw():
    """The reference's raw step over its ``stacked_consts`` (hpc(0.02)
    with i_e = 800 pA, 4x2, drive off), int32 and compact, and over shard
    STAND_IN_SHARD's consts and state on every shard: N_REF steps each,
    rasters (N_REF, 8, n_local)."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", REF_RAW_CODE], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    return {k: np.unpackbits(np.frombuffer(bytes.fromhex(v["bits"]),
                                           np.uint8))[:np.prod(v["shape"])]
            .reshape(v["shape"]).astype(bool) for k, v in res.items()}


@pytest.mark.parametrize("sweep", ["flat", "cuda"])
@pytest.mark.parametrize("case", ["i32", "compact", "stand_in"])
def test_raw_step_equals_reference_raw_step(raw_net, reference_raw, sweep,
                                            case):
    """The port's raw step gives the reference raw step's raster bitwise,
    drive off, on ``"flat"`` and the ``"cuda"`` twin: over
    ``stacked_consts(net)`` in int32 and compact dtypes (the reference
    widening both alike), and one shard stepped alone through
    :class:`StandInExchange` against the reference's grid whose every
    shard holds that shard's consts and state (every payload the local
    one, which is what the stand-in makes up)."""
    spec, stdp, net, table = raw_net
    ref = reference_raw[case]
    assert ref.sum() > 50, "vacuous - nothing spiked"
    if case == "stand_in":   # the reference's shards all alike
        assert (ref == ref[:, :1]).all()
    cfg = dist.DistributedConfig(engine=engine.EngineConfig(
        dt=0.1, stdp=stdp, sweep=sweep, external_drive=False))
    blocked = sweep == "cuda"
    consts = dist.stacked_consts(net, needs_blocked=blocked)
    kw = dict(max_delay=net.max_delay, n_local=net.n_local,
              n_mirror=net.n_mirror,
              blocked_meta=net.blocked_meta if blocked else None,
              device=CPU)
    shards = None
    if case == "compact":
        consts = _compact(consts, net.n_mirror)
    elif case == "stand_in":
        shards = [STAND_IN_SHARD]
        consts = {k: v[STAND_IN_SHARD:STAND_IN_SHARD + 1]
                  for k, v in consts.items()}
        kw.update(shards=(STAND_IN_SHARD,), exchange=dist.StandInExchange)
        ref = ref[:, :1]
    raw = dist.make_raw_distributed_step(
        make_test_mesh((4, 2)), list(spec.groups), cfg, **kw)
    st = dist.init_stacked_state(net, list(spec.groups), sweep=sweep,
                                 shards=shards, device=CPU)
    _, spikes = raw.run(st, consts, N_REF)
    np.testing.assert_array_equal(spikes.numpy(), ref)


# --------------------------------------------------------------------------
# meta
# --------------------------------------------------------------------------

def _meta_cell(dims, mesh, wire, *, compact=False):
    cfg = dist.DistributedConfig(
        engine=engine.EngineConfig(dt=0.1, stdp=models.HPC_STDP,
                                   sweep="flat"),
        comm_mode="area", spike_wire=wire)
    step = dist.make_raw_distributed_step(
        mesh, [snn.LIFParams()], cfg, max_delay=dims["max_delay"],
        n_local=dims["n_local"], n_mirror=dims["n_mirror"], shards=(0,),
        exchange=dist.StandInExchange, device="meta")
    state, consts = dryrun_snn.state_and_consts_meta(dims, mesh,
                                                     compact=compact)
    drive = torch.empty((1, dims["n_local"]), device="meta")
    bound = step.bind(consts)
    with OpCounter() as costs:
        fin, bits = bound(state, drive)
    assert bits.device.type == "meta" and bits.shape == (1, dims["n_local"])
    assert fin.weights.shape == state.weights.shape
    g = bound.exchange.gathered_bytes
    return g["world"] + g["row"], costs


def test_meta_step_at_the_reference_dims():
    """``shard_dims(20_000, 400_000, 8, 2, max_delay=16)`` on a 4x2 mesh
    (the reference's ``test_raw_dryrun_step_compiles_for_sparse_wire``):
    packed and sparse both run on ``meta``; their gathered bytes equal the
    port's and the reference's ``wire_bytes_for_dims``; sparse < packed;
    the crossover in (0.02, 1/32)."""
    mesh = make_test_mesh((4, 2))
    dims = dryrun_snn.shard_dims(20_000, 400_000, 8, 2, max_delay=16)
    res = {}
    for wire in ("packed", "sparse"):
        got, costs = _meta_cell(dims, mesh, wire)
        kw = dict(n_shards=8, row_width=2, n_local=dims["n_local"],
                  b_pad=dims["b_pad"])
        assert got == dist.wire_bytes_for_dims("area", wire, **kw)
        assert got == ref_dist.wire_bytes_for_dims("area", wire, **kw)
        assert costs.flops > dims["n_edges"]
        assert costs.traffic_bytes > 4 * dims["n_edges"]
        assert "aten::index_add_" in costs.by_op
        res[wire] = got
    assert res["sparse"] < res["packed"], res
    from repro_torch.core.wire import sparse_packed_crossover_fraction
    assert 0.02 < sparse_packed_crossover_fraction(dims["n_local"]) < 1 / 32


def test_production_cells_meet_their_wire_model():
    """Every one of the 24 cells of ``main`` (both meshes, scales 1 and 4,
    six variants) runs on ``meta`` with ``collective_bytes ==
    wire_model_bytes``, the model equal to the reference's
    ``wire_bytes_split``; compact consts count fewer argument bytes."""
    recs = [dryrun_snn.run_cell(scale, mp, w, compact=c, overlap=o,
                                wire_remote=rw)
            for mp in (False, True) for scale in (1.0, 4.0)
            for w, rw, c, o in dryrun_snn.VARIANTS]
    assert len(recs) == 24
    for r in recs:
        assert r["collective_bytes"] == r["wire_model_bytes"], r
        S = 512 if r["mesh"] == "2x16x16" else 256
        ref = ref_dist.wire_bytes_split(
            "area", r["wire"], r["wire_remote"], n_shards=S, row_width=16,
            n_local=r["n_local"], b_pad=r["b_pad"])
        assert (r["wire_bytes_intra"], r["wire_bytes_inter"]) == (
            ref["intra"], ref["inter"])
        assert r["dominant"] in ("compute_s", "memory_s", "collective_s")
        assert r["memory_s"] == r["traffic_bytes"] / dryrun_snn.HBM_BW
    by = {(r["mesh"], r["scale"], r["wire"], r["wire_remote"], r["compact"],
           r["overlap"]): r for r in recs}
    i32 = by[("16x16", 1.0, "packed", "packed", False, True)]
    small = by[("16x16", 1.0, "packed", "packed", True, True)]
    assert small["argument_gib"] < i32["argument_gib"]
    assert by[("16x16", 1.0, "sparse", "sparse", True, True)][
        "collective_bytes"] < small["collective_bytes"]


def test_state_and_consts_meta_shapes_and_dtypes():
    """The reference's shapes, (1, ...) for the one shard; compact: uint16
    ids where ``n_mirror`` allows, int8 delays and channels; off ``meta``
    every id is in range."""
    mesh = make_test_mesh((4, 2))
    dims = dryrun_snn.shard_dims(20_000, 400_000, 8, 2, max_delay=16)
    st, c = dryrun_snn.state_and_consts_meta(dims, mesh, compact=True)
    assert st.ring.shape == (1, 16, dims["n_mirror"])
    assert c["pre_idx"].dtype == torch.uint16
    assert c["delay"].dtype == torch.int8
    assert c["mirror_row_gather"].dtype == torch.int32
    assert c["boundary_slots"].shape == (1, dims["b_pad"])
    st, c = dryrun_snn.state_and_consts_meta(dims, mesh, device=CPU, seed=1)
    assert int(c["pre_idx"].max()) < dims["n_mirror"]
    assert int(c["post_idx"].max()) < dims["n_local"]
    assert 1 <= int(c["delay"].min()) and int(c["delay"].max()) <= 16
    assert int(c["mirror_row_gather"].max()) < 2 * dims["n_local"]
    assert int(c["mirror_remote_gather"].max()) < 8 * dims["b_pad"]
    assert len(st.generators) == 1


def test_materialized_shard_steps_flat_and_cuda():
    """The seeded shard at the reference test's dims, stepped on the CPU:
    ``"flat"`` and the ``"cuda"`` twin (over blocked consts laid out by
    the port's layout code), each on the consts in both dtypes: the same
    spikes all four."""
    mesh = make_test_mesh((4, 2))
    dims = dryrun_snn.shard_dims(20_000, 400_000, 8, 2, max_delay=16)
    blk, meta, _ = dryrun_snn.blocked_consts(
        dryrun_snn.state_and_consts_meta(dims, mesh, device=CPU)[1], dims)
    assert {v.device.type for v in blk.values()} == {"cpu"}
    out = {}
    for sweep, compact in (("flat", False), ("flat", True), ("cuda", False),
                           ("cuda", True)):
        cfg = dist.DistributedConfig(engine=engine.EngineConfig(
            dt=0.1, stdp=models.HPC_STDP, sweep=sweep))
        step = dist.make_raw_distributed_step(
            mesh, list(dryrun_snn.GROUPS), cfg, max_delay=16,
            n_local=dims["n_local"], n_mirror=dims["n_mirror"],
            blocked_meta=meta if sweep == "cuda" else None, shards=(0,),
            exchange=dist.StandInExchange, device=CPU)
        st, consts = dryrun_snn.state_and_consts_meta(
            dims, mesh, compact=compact, device=CPU)
        if sweep == "cuda":
            consts = {**consts, **blk}
        out[(sweep, compact)] = step.run(st, consts, 80)
    s0 = out[("flat", False)][1]
    assert s0.sum() > 0
    for key in (("flat", True), ("cuda", False), ("cuda", True)):
        assert torch.equal(out[key][1], s0), key
    np.testing.assert_allclose(out[("cuda", False)][0].v_m.numpy(),
                               out[("flat", False)][0].v_m.numpy(),
                               atol=1e-3)


def test_mesh_descriptors():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert one.axis_names == ("data", "model") and one.dims == (16, 16)
    assert two.shape == {"pod": 2, "data": 16, "model": 16}
    assert (one.size, two.size) == (256, 512)
    with pytest.raises(ValueError):
        MeshShape(("a", "a"), (2, 2))


# --------------------------------------------------------------------------
# the reference's dry-run module, in a subprocess
# --------------------------------------------------------------------------

REF_CODE = textwrap.dedent("""
    import json
    from repro.launch import dryrun_snn as d
    cases = [(20_000, 400_000, 8, 2, 16)] + [
        (int(1_000_000 * s), int(3_800_000_000 * s), S, 16, 64)
        for s in (1.0, 4.0) for S in (256, 512)]
    dims = [d.shard_dims(n, e, S, rw, max_delay=md)
            for n, e, S, rw, md in cases]
    probe = d.measure_firing_rates(scale=0.02, steps=400)
    print(json.dumps(dict(cases=cases, dims=dims, probe=probe)))
""")


@pytest.fixture(scope="module")
def reference_dryrun():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    out = subprocess.run([sys.executable, "-c", REF_CODE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_shard_dims_match_reference(reference_dryrun):
    for (n, e, S, rw, md), want in zip(reference_dryrun["cases"],
                                       reference_dryrun["dims"]):
        assert dryrun_snn.shard_dims(n, e, S, rw, max_delay=md) == want


def test_probe_matches_reference_partition_and_rate_band(reference_dryrun):
    """The probe at scale 0.02 (400 steps, 4x2 rows) on the CPU through
    the ``"cuda"`` twins: each row holds the reference probe's neurons;
    the firing rate pooled over seeds 0-2 lies within 0.5x-2x of the
    reference probe's (about 20 spikes a run: the two packages' Poisson
    drives differ, and a band this wide is over three Poisson standard
    deviations of the pooled count); the recommendations have the port's
    backend names."""
    ref = reference_dryrun["probe"]
    probes = [dryrun_snn.measure_firing_rates(scale=0.02, steps=400,
                                              seed=s, device=CPU)
              for s in PROBE_SEEDS]
    rate = lambda p: (sum(r["rate_hz"] * r["n"] for r in p["rows"])
                      / sum(r["n"] for r in p["rows"]))
    for p in probes:
        assert [r["n"] for r in p["rows"]] == [r["n"] for r in ref["rows"]]
        assert p["recommended_gate"] == f"cuda:sparse:{p['gate_rate']:g}"
        assert p["recommended_sparse"].startswith("sparse:")
        assert p["gate_blocks_total"] == ref["gate_blocks_total"]
    pooled = float(np.mean([rate(p) for p in probes]))
    assert rate(ref) > 0
    assert 0.5 * rate(ref) <= pooled <= 2.0 * rate(ref), (pooled, rate(ref))
