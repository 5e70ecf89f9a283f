"""The port's ``"bucketed"`` backend, ``register_backend`` and
``engine.synaptic_sweep`` against the reference's.

* ``flat == bucketed`` on hpc_benchmark(0.02) with a constant drive, as
  the reference's ``test_flat_equals_bucketed_sweep``;
* ``flat == bucketed == cuda == cuda:auto`` over 120 STDP steps on the
  mixed network and for every zoo model, against the reference's
  ``flat``, ``bucketed`` and ``pallas``
  (``tests/test_snn_engine.py::test_cross_backend_trajectory_equivalence``,
  ``tests/test_neuron_models.py::test_cross_backend_trajectory_equivalence_per_model``);
* ``synaptic_sweep`` in every mode against the reference's on a built
  shard (``tests/test_kernels.py::test_backend_sweeps_agree_on_built_graph``);
* the bucket walk against the masked pass the stacked step's shard views
  take;
* the registry: ``register_backend``.

Inputs come from numpy with a seed and go to both packages.
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import builder as ref_builder
from repro.core import decomposition as ref_decomposition
from repro.core import engine as ref_engine
from repro.core import models as ref_models
from repro.core import neuron_models as ref_nm
from repro.core import snn as ref_snn
from repro_torch import convert
from repro_torch.core import backends, builder, decomposition, engine
from repro_torch.core import models, neuron_models, snn

CPU = "cpu"


def _port_graph(ref_g):
    return convert.graph_from_numpy(
        {f.name: getattr(ref_g, f.name)
         for f in dataclasses.fields(ref_g)}).to(CPU)


def _i_e_800(m):
    spec, stdp = m.hpc_benchmark(scale=0.02, stdp=True)
    return dataclasses.replace(
        spec, groups=[dataclasses.replace(spec.groups[0], i_e=800.0)]), stdp


def _mixed_spec(b, dec, s):
    """``tests/test_snn_engine.py::mixed_backend_spec`` from a package's
    modules: mixed channels, delays 1-6, plastic E->E edges, padding."""
    ne, ni = 24, 9
    area = dec.AreaSpec("a", ne + ni, positions=np.zeros((ne + ni, 3)))
    exc = s.LIFParams(i_e=800.0, t_ref=1.0)
    inh = s.LIFParams(i_e=800.0, t_ref=1.0, tau_m=8.0)
    return b.NetworkSpec(
        areas=[area], groups=[exc, inh],
        populations=[b.Population("E", 0, 0, ne),
                     b.Population("I", 0, 1, ni)],
        projections=[
            b.Projection(0, 0, 5, 45.0, 5.0, 1, 5, channel=0, plastic=True),
            b.Projection(0, 1, 3, 45.0, 5.0, 1, 3, channel=0),
            b.Projection(1, 0, 4, -200.0, 10.0, 2, 6, channel=1),
            b.Projection(1, 1, 2, -200.0, 10.0, 1, 2, channel=1)],
        max_delay=8, seed=3)


def _ref_runs(ref_spec, stdp, n_steps, sweeps, model="lif"):
    """The reference's ``engine.run`` per sweep (drive off, key 0):
    ``({sweep: (spikes, weights, v_m)}, graph, draws)``, ``draws`` the
    reference's per-step model uniforms for a stochastic model."""
    g_ref = ref_builder.build_shards(ref_spec,
                                     ref_builder.decompose(ref_spec, 1))[0]
    gd = g_ref.device_arrays()
    table = ref_nm.get_model(model).make_param_table(list(ref_spec.groups),
                                                     dt=0.1)
    out = {}
    for sweep in sweeps:
        cfg = ref_engine.EngineConfig(dt=0.1, stdp=stdp, sweep=sweep,
                                      external_drive=False,
                                      neuron_model=model)
        st = ref_engine.init_state(gd, list(ref_spec.groups),
                                   jax.random.key(0), neuron_model=model)
        fin, sp = jax.jit(lambda s, c=cfg: ref_engine.run(
            s, gd, table, c, n_steps))(st)
        out[sweep] = (np.asarray(sp), np.asarray(fin.weights),
                      np.asarray(fin.neurons.v_m))
    draws = None
    if ref_nm.get_model(model).stochastic:
        draw = jax.jit(lambda t: ref_nm._gid_uniform(st.drive_key, t,
                                                     gd.global_id))
        draws = torch.from_numpy(np.stack(
            [np.asarray(draw(jnp.int32(t))) for t in range(n_steps)]))
    return out, g_ref, draws


def _port_runs(spec, stdp, g, n_steps, sweeps, model="lif", uniform=None):
    table = neuron_models.get_model(model).make_param_table(
        list(spec.groups), 0.1, device=CPU)
    out = {}
    for sweep in sweeps:
        cfg = engine.EngineConfig(dt=0.1, stdp=stdp, sweep=sweep,
                                  external_drive=False, neuron_model=model)
        st = engine.init_state(g, list(spec.groups), 0, neuron_model=model,
                               device=CPU)
        fin, sp = engine.run(st, g, table, cfg, n_steps,
                             model_uniform=uniform, device=CPU)
        out[sweep] = (sp.numpy(), fin.weights.numpy(),
                      fin.neurons.v_m.numpy())
    return out


def test_flat_equals_bucketed_sweep():
    """hpc_benchmark(0.02), i_e = 800 pA, STDP, 150 steps: the port's flat
    and bucketed give the reference's flat and bucketed rasters, weights
    allclose, v_m within 1e-4 (XLA contracts the LIF step's multiply-adds
    on the CPU; the sweeps themselves agree bitwise,
    :func:`test_synaptic_sweep_matches_reference`)."""
    ref_spec, ref_stdp = _i_e_800(ref_models)
    ref, g_ref, _ = _ref_runs(ref_spec, ref_stdp, 150, ("flat", "bucketed"))
    spec, stdp = _i_e_800(models)
    got = _port_runs(spec, stdp, _port_graph(g_ref), 150,
                     ("flat", "bucketed"))
    assert ref["flat"][0].sum() > 100, "nothing spiked - vacuous"
    for sweep, (s, w, v) in got.items():
        for rs, rw, rv in ref.values():
            np.testing.assert_array_equal(s, rs, err_msg=sweep)
            assert np.allclose(w, rw), sweep
    np.testing.assert_allclose(got["bucketed"][2], ref["bucketed"][2],
                               atol=1e-4)


def test_cross_backend_trajectory_equivalence():
    """``flat == bucketed == cuda == cuda:auto`` (plain twins) over 120
    STDP steps on the mixed network, each against the reference's flat,
    bucketed and pallas: identical rasters, weights within 1e-4."""
    ref_spec = _mixed_spec(ref_builder, ref_decomposition, ref_snn)
    sweeps = ("flat", "bucketed", "cuda", "cuda:auto")
    ref, g_ref, _ = _ref_runs(ref_spec, ref_models.HPC_STDP, 120,
                              ("flat", "bucketed", "pallas"))
    spec = _mixed_spec(builder, decomposition, snn)
    got = _port_runs(spec, models.HPC_STDP, _port_graph(g_ref), 120, sweeps)
    delay = np.asarray(g_ref.delay)
    assert (delay == 0).any(), "no padding edges - vacuous"
    assert (np.asarray(g_ref.channel)[delay > 0] == 1).any()
    assert ref["flat"][0].sum() > 10, "nothing spiked - vacuous"
    for sweep, (s, w, _) in got.items():
        for ref_sweep, (rs, rw, _) in ref.items():
            msg = f"port {sweep} vs reference {ref_sweep}"
            np.testing.assert_array_equal(s, rs, err_msg=msg)
            np.testing.assert_allclose(w, rw, atol=1e-4, err_msg=msg)


@pytest.mark.parametrize("model", ["lif", "izhikevich", "adex", "poisson"])
def test_cross_backend_trajectory_equivalence_per_model(model):
    """Every zoo model, ``model_demo(model, 0.004)``, 120 steps, STDP where
    the net has plastic edges: the port's flat, bucketed and cuda give the
    reference's bucketed raster; weights within 1e-4, v_m within 1e-3 (the
    reference's tolerances).  The stochastic model takes the reference's
    uniforms."""
    stdp_on = model != "poisson"
    ref_spec, ref_stdp = ref_models.model_demo(model, 0.004, stdp=stdp_on)
    ref, g_ref, draws = _ref_runs(ref_spec, ref_stdp, 120, ("bucketed",),
                                  model=model)
    spec, stdp = models.model_demo(model, 0.004, stdp=stdp_on)
    got = _port_runs(spec, stdp, _port_graph(g_ref), 120,
                     ("flat", "bucketed", "cuda"), model=model,
                     uniform=draws)
    rs, rw, rv = ref["bucketed"]
    assert rs.sum() > 10, f"vacuous: {model} demo net barely spiked"
    for sweep, (s, w, v) in got.items():
        msg = f"{model}: port {sweep} vs reference bucketed"
        np.testing.assert_array_equal(s, rs, err_msg=msg)
        np.testing.assert_allclose(w, rw, atol=1e-4, err_msg=msg)
        np.testing.assert_allclose(v, rv, atol=1e-3, err_msg=msg)


@pytest.mark.parametrize("mode,ref_mode", [
    ("flat", "flat"), ("bucketed", "bucketed"), ("cuda", "pallas"),
    ("cuda:auto", "pallas")])
def test_synaptic_sweep_matches_reference(mode, ref_mode):
    """``engine.synaptic_sweep`` on a built hpc_benchmark(0.02) shard, a
    seeded ring at t = 77: sums within 1e-3 of the reference's in the same
    mode (and of the port's flat), arrivals flat-ordered and equal."""
    ref_spec, _ = ref_models.hpc_benchmark(scale=0.02)
    g_ref = ref_builder.build_shards(
        ref_spec, ref_builder.decompose(ref_spec, 1))[0]
    gd = g_ref.device_arrays()
    rng = np.random.default_rng(11)
    ring = (rng.uniform(size=(ref_spec.max_delay, g_ref.n_mirror))
            < 0.15).astype(np.float32)
    rex, rin, rarr = ref_engine.synaptic_sweep(
        gd, gd.weight_init, jnp.asarray(ring), jnp.asarray(77, jnp.int32),
        mode=ref_mode)
    g = _port_graph(g_ref)
    args = (g, g.weight_init, torch.from_numpy(ring),
            torch.tensor(77, dtype=torch.int32))
    ex, inh, arr = engine.synaptic_sweep(*args, mode=mode)
    ex_f, in_f, arr_f = engine.synaptic_sweep(*args)
    assert arr.shape == (g.n_edges,) and float(arr.sum()) > 0
    for a, b in ((ex, rex), (inh, rin), (ex, ex_f), (inh, in_f)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3,
                                   err_msg=mode)
    np.testing.assert_array_equal(arr.numpy(), np.asarray(rarr))
    assert torch.equal(arr, arr_f)
    if mode == "bucketed":
        np.testing.assert_array_equal(ex.numpy(), np.asarray(rex))
        np.testing.assert_array_equal(inh.numpy(), np.asarray(rin))


def test_bucket_walk_equals_masked_pass():
    """Without ``bucket_ptr`` (the stacked step's shard views) the
    bucketed backend takes one masked pass per delay: the same arrivals,
    sums within float rounding; ``sweep_overlap`` writes the fresh row."""
    spec, _ = models.hpc_benchmark(scale=0.02)
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(CPU)
    b = backends.get_backend("bucketed")
    walk = b.prepare(g)
    masked = dataclasses.replace(walk, bucket_ptr=None)
    rng = np.random.default_rng(5)
    ring = torch.from_numpy((rng.uniform(size=(g.max_delay, g.n_mirror))
                             < 0.2).astype(np.float32))
    t = torch.tensor(21, dtype=torch.int32)
    ex_w, in_w, a_w = b.sweep(walk, g.weight_init, ring, t)
    ex_m, in_m, a_m = b.sweep(masked, g.weight_init, ring, t)
    assert torch.equal(a_w, a_m) and float(a_w.sum()) > 0
    torch.testing.assert_close(ex_w, ex_m, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(in_w, in_m, rtol=1e-5, atol=1e-3)
    fresh = (torch.rand(g.n_mirror, generator=torch.Generator().manual_seed(
        2)) < 0.3).float()
    ex_o, in_o, a_o, ring_o = b.sweep_overlap(walk, g.weight_init, ring, t,
                                              fresh)
    assert torch.equal(ring_o[(21 - 1) % g.max_delay], fresh)
    ex_r, in_r, a_r = b.sweep(walk, g.weight_init, ring_o, t)
    assert torch.equal(a_o, a_r) and torch.equal(ex_o, ex_r)


def test_register_backend(monkeypatch):
    """A registered name raises unless ``overwrite``; a registered backend
    is listed and runs through ``EngineConfig(sweep=)``."""
    monkeypatch.setattr(backends, "_REGISTRY", dict(backends._REGISTRY))
    assert backends.available_backends() == ("bucketed", "cuda",
                                             "cuda:sparse", "flat")
    with pytest.raises(ValueError, match="already registered"):
        backends.register_backend("flat", backends.FlatBackend())
    mine = backends.BucketedBackend()
    backends.register_backend("flat", mine, overwrite=True)
    assert backends.get_backend("flat") is mine
    backends.register_backend("mine", backends.FlatBackend())
    assert "mine" in backends.available_backends()
    with pytest.raises(ValueError, match="unknown sweep backend"):
        backends.get_backend("triton")

    spec, stdp = _i_e_800(models)
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(CPU)
    table = snn.make_param_table(list(spec.groups), 0.1, device=CPU)
    out = {}
    for sweep in ("mine", "bucketed"):
        cfg = engine.EngineConfig(dt=0.1, stdp=stdp, sweep=sweep,
                                  external_drive=False)
        st = engine.init_state(g, list(spec.groups), 0, device=CPU)
        out[sweep] = engine.run(st, g, table, cfg, 150, device=CPU)[1]
    assert out["mine"].sum() > 0 and torch.equal(out["mine"],
                                                 out["bucketed"])
