"""Port engine vs reference engine on the slice's main path.

* the port's ``"cuda"`` backend on the CPU (its kernels' plain twins)
  against the reference's ``"pallas"`` (interpret mode) on
  ``mixed_backend_spec``, 120 steps, STDP on, drive off;
* the port's ``"flat"`` against the reference's ``"flat"`` on
  ``hpc_benchmark(0.02, stdp=True)`` with the reference's per-step Poisson
  drive injected;
* an fp64 run, the state round trip, the device rule and the isolation of
  the port from JAX.

Both packages start from the same state through ``repro_torch.convert``.
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backends as ref_backends
from repro.core import builder as ref_builder
from repro.core import decomposition as ref_decomposition
from repro.core import engine as ref_engine
from repro.core import models as ref_models
from repro.core import snn as ref_snn
from repro_torch import convert
from repro_torch.core import backends, builder, decomposition, engine
from repro_torch.core import models, neuron_models, snn, stdp

CPU = "cpu"
SRC = str(Path(__file__).resolve().parents[1] / "src")


def mixed_spec(b, dec, s):
    """``tests/test_snn_engine.py::mixed_backend_spec`` built from a given
    package's modules (builder, decomposition, snn): two groups, mixed
    channels, heterogeneous delays, plastic E->E edges and real padding."""
    ne, ni = 24, 9
    area = dec.AreaSpec("a", ne + ni, positions=np.zeros((ne + ni, 3)))
    exc = s.LIFParams(i_e=800.0, t_ref=1.0)
    inh = s.LIFParams(i_e=800.0, t_ref=1.0, tau_m=8.0)
    pops = [b.Population("E", 0, 0, ne), b.Population("I", 0, 1, ni)]
    projections = [
        b.Projection(0, 0, 5, 45.0, 5.0, 1, 5, channel=0, plastic=True),
        b.Projection(0, 1, 3, 45.0, 5.0, 1, 3, channel=0),
        b.Projection(1, 0, 4, -200.0, 10.0, 2, 6, channel=1),
        b.Projection(1, 1, 2, -200.0, 10.0, 1, 2, channel=1),
    ]
    return b.NetworkSpec(areas=[area], groups=[exc, inh], populations=pops,
                         projections=projections, max_delay=8, seed=3)


def _ref_setup(spec, dtype=jnp.float32):
    g = ref_builder.build_shards(spec, ref_builder.decompose(spec, 1))[0]
    table = ref_snn.make_param_table(list(spec.groups), dt=0.1, dtype=dtype)
    st = ref_engine.init_state(g.device_arrays(), list(spec.groups),
                               jax.random.key(0), dtype=dtype)
    return g, table, st


def _port_graph(ref_g):
    fields = {f.name: getattr(ref_g, f.name)
              for f in dataclasses.fields(ref_g)}
    return convert.graph_from_numpy(fields).to(CPU)


def _ref_leaves(st):
    return {
        "neurons.v_m": st.neurons.v_m, "neurons.syn_ex": st.neurons.syn_ex,
        "neurons.syn_in": st.neurons.syn_in,
        "neurons.ref_count": st.neurons.ref_count,
        "neurons.spike": st.neurons.spike, "ring": st.ring,
        "weights": st.weights, "traces.k_pre": st.traces.k_pre,
        "traces.k_post": st.traces.k_post, "t": st.t,
        "gate_overflow": st.gate_overflow}


def _live_mirrors(g):
    """Mirrors with at least one outgoing edge: the reference's segment_max
    leaves -inf on the others, the port 0 (see repro_torch.core.engine)."""
    d = np.asarray(g.delay)
    live = np.zeros(g.n_mirror, bool)
    live[np.asarray(g.pre_idx)[d > 0]] = True
    return live


def test_cuda_backend_twins_match_reference_pallas():
    """The kernel backend's plain twins == the reference's Pallas kernels
    (interpret) over the reference's own 120-step horizon: identical spike
    rasters, weights within 1e-4 (the reference's own flat-vs-pallas
    bound: the one-hot matmul and index_add_ sum in different orders)."""
    ref_spec = mixed_spec(ref_builder, ref_decomposition, ref_snn)
    g_ref, table_ref, st_ref = _ref_setup(ref_spec)
    cfg_ref = ref_engine.EngineConfig(dt=0.1, stdp=ref_models.HPC_STDP,
                                      sweep="pallas", external_drive=False)
    gd = g_ref.device_arrays()
    fin_ref, sp_ref = jax.jit(
        lambda s: ref_engine.run(s, gd, table_ref, cfg_ref, 120))(st_ref)

    g = _port_graph(g_ref)
    st = convert.state_from_numpy(_ref_leaves(st_ref), g, sweep="cuda",
                                  device=CPU)
    assert st.weights_layout == f"blocked:{g.blocked.pb}x{g.blocked.eb}"
    cfg = engine.EngineConfig(dt=0.1, stdp=models.HPC_STDP, sweep="cuda",
                              external_drive=False)
    spec = mixed_spec(builder, decomposition, snn)
    table = snn.make_param_table(list(spec.groups), 0.1, device=CPU)
    np.testing.assert_array_equal(table.numpy(), np.asarray(table_ref))
    fin, sp = engine.run(st, g, table, cfg, 120, device=CPU)

    sp_ref = np.asarray(sp_ref)
    assert (np.asarray(g_ref.delay) == 0).any(), "no padding edges"
    assert sp_ref.sum() > 10, "nothing spiked - vacuous"
    np.testing.assert_array_equal(sp.numpy(), sp_ref)
    assert fin.weights_layout == "flat"
    np.testing.assert_allclose(fin.weights.numpy(),
                               np.asarray(fin_ref.weights), atol=1e-4)
    live = _live_mirrors(g_ref)
    np.testing.assert_allclose(fin.traces.k_pre.numpy()[live],
                               np.asarray(fin_ref.traces.k_pre)[live],
                               rtol=1e-5)
    assert np.isneginf(np.asarray(fin_ref.traces.k_pre)[~live]).all()


def _reference_drives(g_ref, st_ref, n_steps, dt=0.1):
    """Replay the reference's key stream: ``engine_step`` splits the state
    key each step and draws ``_poisson_drive`` from the second half."""
    gd = g_ref.device_arrays()
    key, out = st_ref.key, []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(ref_engine._poisson_drive(sub, gd, dt,
                                                        jnp.float32)))
    return np.stack(out)


def test_flat_backend_matches_reference_flat_with_injected_drive():
    """hpc_benchmark(0.02, stdp=True), 120 steps, the reference's own
    Poisson draws injected: identical spikes; voltages, traces and weights
    within fp32 tolerance (XLA's and torch's CPU kernels may contract or
    order float ops differently)."""
    ref_spec, _ = ref_models.hpc_benchmark(0.02, stdp=True)
    g_ref, table_ref, st_ref = _ref_setup(ref_spec)
    # from rest this network is silent for ~250 steps; both packages start
    # instead from one random state around threshold, so 120 steps spike
    v0 = np.random.default_rng(4).uniform(-56.0, -49.5, g_ref.n_local)
    st_ref = dataclasses.replace(st_ref, neurons=dataclasses.replace(
        st_ref.neurons, v_m=jnp.asarray(v0, jnp.float32)))
    n = 120
    cfg_ref = ref_engine.EngineConfig(dt=0.1, stdp=ref_models.HPC_STDP,
                                      sweep="flat")
    gd = g_ref.device_arrays()
    fin_ref, sp_ref = jax.jit(
        lambda s: ref_engine.run(s, gd, table_ref, cfg_ref, n))(st_ref)

    g = _port_graph(g_ref)
    st = convert.state_from_numpy(_ref_leaves(st_ref), g, sweep="flat",
                                  device=CPU)
    drive = torch.from_numpy(_reference_drives(g_ref, st_ref, n))
    cfg = engine.EngineConfig(dt=0.1, stdp=models.HPC_STDP, sweep="flat")
    table = torch.from_numpy(np.array(table_ref))
    fin, sp = engine.run(st, g, table, cfg, n, drive=drive, device=CPU)

    sp_ref = np.asarray(sp_ref)
    assert sp_ref.sum() > 10 and drive.abs().sum() > 0, "vacuous"
    np.testing.assert_array_equal(sp.numpy(), sp_ref)
    np.testing.assert_allclose(fin.neurons.v_m.numpy(),
                               np.asarray(fin_ref.neurons.v_m), atol=1e-4)
    np.testing.assert_allclose(fin.weights.numpy(),
                               np.asarray(fin_ref.weights), atol=1e-4)
    live = _live_mirrors(g_ref)
    np.testing.assert_allclose(fin.traces.k_pre.numpy()[live],
                               np.asarray(fin_ref.traces.k_pre)[live],
                               rtol=1e-5)
    np.testing.assert_allclose(fin.traces.k_post.numpy(),
                               np.asarray(fin_ref.traces.k_post), rtol=1e-5)


def test_hpc_benchmark_fp64_runs():
    """The engine is dtype-generic on the flat backend (the paper runs
    fp64): 200 steps keep float64 and stay finite."""
    spec, _ = models.hpc_benchmark(scale=0.01, stdp=False)
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(CPU)
    table = snn.make_param_table(list(spec.groups), 0.1,
                                 dtype=torch.float64, device=CPU)
    cfg = engine.EngineConfig(dt=0.1, sweep="flat")
    st = engine.init_state(g, list(spec.groups), 0, dtype=torch.float64,
                           device=CPU)
    fin, spikes = engine.run(st, g, table, cfg, 200, device=CPU)
    assert fin.neurons.v_m.dtype == torch.float64
    assert fin.ring.dtype == torch.float64
    assert torch.isfinite(fin.neurons.v_m).all()
    assert spikes.shape == (200, g.n_local)


def test_cuda_overlap_sweep_equals_ring_write_then_sweep():
    """``sweep_overlap``'s fresh bits (K1 with ``fresh``) == writing them to
    slot t-1 first and sweeping (the base schedule on the flat backend)."""
    spec, _ = models.hpc_benchmark(0.02)
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(CPU)
    rng = np.random.default_rng(1)
    ring = torch.from_numpy(
        (rng.uniform(size=(g.max_delay, g.n_mirror)) < 0.3).astype(
            np.float32))
    fresh = torch.from_numpy(rng.uniform(size=g.n_mirror) < 0.3)
    t = torch.tensor(5, dtype=torch.int32)
    cb, fb = backends.get_backend("cuda"), backends.get_backend("flat")
    lc, lf = cb.prepare(g), fb.prepare(g)
    w = g.weight_init
    ex_c, in_c, arr_c, ring_c = cb.sweep_overlap(
        lc, cb.to_native_weights(lc, w), ring, t, fresh)
    ex_f, in_f, arr_f, ring_f = fb.sweep_overlap(lf, w, ring, t, fresh)
    assert torch.equal(ring_c, ring_f)
    assert torch.equal(backends.flat_edge_values(lc, arr_c, "blocked"),
                       arr_f)
    assert arr_f.sum() > 0
    # same edges, different summation order (blocked vs flat)
    torch.testing.assert_close(ex_c, ex_f, rtol=0, atol=1e-3)
    torch.testing.assert_close(in_c, in_f, rtol=0, atol=1e-3)


def test_state_roundtrip_and_layouts():
    ref_spec = mixed_spec(ref_builder, ref_decomposition, ref_snn)
    g_ref, _, st_ref = _ref_setup(ref_spec)
    leaves = {k: np.asarray(v) for k, v in _ref_leaves(st_ref).items()}
    rng = np.random.default_rng(2)
    real = np.asarray(g_ref.delay) > 0
    leaves["weights"] = np.where(
        real, rng.uniform(1, 50, real.size), 0).astype(np.float32)
    leaves["neurons.v_m"] = rng.uniform(-70, -50, leaves["neurons.v_m"].size
                                        ).astype(np.float32)
    leaves["t"] = np.asarray(17, np.int32)
    leaves["gate_overflow"] = np.asarray(3, np.int32)
    g = _port_graph(g_ref)
    for sweep in ("cuda", "cuda:sparse", "flat"):
        st = convert.state_from_numpy(leaves, g, sweep=sweep, device=CPU)
        back = convert.state_to_numpy(st, g)
        assert set(back) == set(convert.STATE_LEAVES)
        for k in convert.STATE_LEAVES:
            np.testing.assert_array_equal(back[k], leaves[k], err_msg=k)


def test_mismatched_blocked_shapes_rejected():
    spec, _ = models.hpc_benchmark(0.02)
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(CPU)
    table = snn.make_param_table(list(spec.groups), 0.1, device=CPU)
    cfg = engine.EngineConfig(dt=0.1, external_drive=False)
    st = engine.init_state(g, list(spec.groups), 0, sweep="cuda", device=CPU)
    bad_len = dataclasses.replace(st, weights=torch.cat(
        [st.weights, torch.zeros(128)]))
    with pytest.raises(ValueError, match="block shapes"):
        engine.engine_step(bad_len, g, table, cfg)
    bad_tag = dataclasses.replace(st, weights_layout="blocked:64x512")
    with pytest.raises(ValueError, match="block shapes"):
        engine.engine_step(bad_tag, g, table, cfg)


def test_registries_and_defaults():
    assert backends.available_backends() == ("bucketed", "cuda",
                                             "cuda:sparse", "flat")
    assert engine.EngineConfig().sweep == "cuda"
    with pytest.raises(ValueError, match="unknown sweep backend"):
        backends.get_backend("pallas")
    assert neuron_models.available_models() == ("adex", "izhikevich", "lif",
                                                "poisson")
    assert engine.EngineConfig().neuron_model == "lif"
    for name in ("izhikevich", "adex", "poisson", "lif+poisson"):
        assert neuron_models.get_model(name).name == name
    assert set(ref_backends.available_backends()) >= {"flat", "pallas"}


def test_entry_points_need_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec, _ = models.hpc_benchmark(0.01)
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        g.to()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        snn.make_param_table(list(spec.groups), 0.1)
    gid = np.zeros(4, np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        snn.init_state(4, gid, list(spec.groups))
    assert snn.init_state(4, gid, list(spec.groups),
                          device=CPU).v_m.device.type == CPU
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stdp.init_traces(3, 4)
    assert stdp.init_traces(3, 4, device=CPU).k_pre.device.type == CPU
    izh = neuron_models.get_model("izhikevich")
    izh_groups = [neuron_models.IzhikevichParams()]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        izh.make_param_table(izh_groups, 0.1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        izh.init_state(4, gid, izh_groups)
    gc = g.to(CPU)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.init_state(gc, list(spec.groups))
    st = engine.init_state(gc, list(spec.groups), device=CPU)
    table = snn.make_param_table(list(spec.groups), 0.1, device=CPU)
    cfg = engine.EngineConfig(sweep="flat")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.run(st, gc, table, cfg, 1)
    engine.run(st, gc, table, cfg, 1, device=CPU)


def test_port_imports_neither_jax_nor_reference():
    """Importing every module of ``repro_torch`` loads no ``jax`` and no
    module of the reference package (fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "for m in ('kernels.synaptic_gather', 'kernels.izhikevich_step',\n"
        "          'kernels.adex_step', 'kernels._two_variable',\n"
        "          'kernels.stdp_update', 'core.neuron_models',\n"
        "          'core.models', 'core.autotune', 'configs',\n"
        "          'configs.qwen2_5_3b', 'models.layers',\n"
        "          'models.attention', 'models.transformer',\n"
        "          'models.model', 'serve.engine',\n"
        "          'kernels.flash_attention', 'core.wire',\n"
        "          'core.distributed', 'core.multihost', 'launch.mesh',\n"
        "          'launch.multihost', 'serve.sessions', 'serve.snn',\n"
        "          'diff.surrogate', 'diff.rollout', 'diff.classify',\n"
        "          'diff.inverse', 'train.optimizer', 'train.loop',\n"
        "          'configs.shapes', 'sharding.rules', 'launch.dryrun',\n"
        "          'launch.roofline', 'utils.op_costs'):\n"
        "    assert 'repro_torch.' + m in sys.modules, m\n")
    out = subprocess.run([sys.executable, "-c", code], env={"PYTHONPATH": SRC,
                         "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
