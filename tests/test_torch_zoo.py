"""Port neuron-model zoo and scenario registry vs the reference.

* K4 (Izhikevich) and K5 (AdEx): the plain twins against the reference's
  ``IzhikevichModel.step`` / ``AdExModel.step`` and against the Pallas
  kernels in interpret mode, on seeded random inputs;
* every model's table and initial state, ``array_equal``;
* per-model trajectories: ``model_demo(model, 0.004)`` for 120 steps, the
  port's ``flat`` and ``cuda`` (plain twins on the CPU) against the
  reference's ``flat`` and ``pallas`` - the reference's own
  ``test_cross_backend_trajectory_equivalence_per_model``, with the
  reference's ``_gid_uniform`` draws injected for the stochastic models;
* the port's own draws: order- and decomposition-invariant, at the
  requested rate, emitter state frozen;
* every scenario's build arrays and ``scenario_id``;
* the struct check and the state carried across for every model.
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import builder as ref_builder
from repro.core import engine as ref_engine
from repro.core import models as ref_models
from repro.core import neuron_models as ref_nm
from repro.kernels.adex_step import adex_step_kernel as ref_adex_kernel
from repro.kernels.izhikevich_step import \
    izhikevich_step_kernel as ref_izh_kernel
from repro_torch import convert
from repro_torch.core import builder, engine, models, neuron_models
from repro_torch.core.layout import BlockedGraph
from repro_torch.kernels import adex_step as adex_mod
from repro_torch.kernels import izhikevich_step as izh_mod

CPU = "cpu"
MODELS = ("lif", "izhikevich", "adex", "poisson")
F32_ULP_AT_1 = 2.0 ** -23


def _port_graph(ref_g):
    fields = {f.name: getattr(ref_g, f.name)
              for f in dataclasses.fields(ref_g)}
    return convert.graph_from_numpy(fields).to(CPU)


def _ref_draws(st_ref, gd, n_steps):
    """The reference's per-neuron model uniforms: ``engine_step`` hands
    ``_gid_uniform(drive_key, t, global_id)`` to a stochastic model."""
    draw = jax.jit(lambda t: ref_nm._gid_uniform(st_ref.drive_key, t,
                                                 gd.global_id))
    return torch.from_numpy(np.stack([np.asarray(draw(jnp.int32(t)))
                                      for t in range(n_steps)]))


# --------------------------------------------------------------------------
# K4 / K5 plain twins vs the reference
# --------------------------------------------------------------------------

def _izh_inputs(rng, n, groups):
    gs = [dict(a=0.02 + 0.04 * i, d=8.0 - 3 * i, i_e=5.0 * i,
               t_ref=0.3 * i, i_scale=1.0 - 0.2 * i) for i in range(groups)]
    state = dict(v=rng.uniform(-70, 25, n), u=rng.uniform(-16, 0, n),
                 syn_ex=rng.uniform(0, 30, n), syn_in=rng.uniform(-30, 0, n))
    inputs = dict(input_ex=rng.uniform(0, 20, n),
                  input_in=rng.uniform(-20, 0, n))
    return (ref_nm.IzhikevichParams, neuron_models.IzhikevichParams, gs,
            state, inputs)


def _adex_inputs(rng, n, groups):
    gs = [dict(i_e=400.0 * i, a=4.0 + 2 * i, t_ref=2.0 - 0.7 * i)
          for i in range(groups)]
    # v up to -35 mV: above v_t + 7.5 delta_t, the exponential's steep end
    state = dict(v=rng.uniform(-75, -35, n), w=rng.uniform(0, 100, n),
                 syn_ex=rng.uniform(0, 300, n),
                 syn_in=rng.uniform(-300, 0, n))
    inputs = dict(input_ex=rng.uniform(0, 50, n),
                  input_in=rng.uniform(-50, 0, n))
    return ref_nm.AdExParams, neuron_models.AdExParams, gs, state, inputs


KERNELS = {
    "izhikevich": (_izh_inputs, izh_mod.izhikevich_step, ref_izh_kernel,
                   ("v", "u", "syn_ex", "syn_in", "ref_count", "spike")),
    "adex": (_adex_inputs, adex_mod.adex_step, ref_adex_kernel,
             ("v", "w_ad", "syn_ex", "syn_in", "ref_count", "spike")),
}


@pytest.mark.parametrize("n,groups", [(512, 1), (1000, 3), (512, 3),
                                      (1000, 1)])
@pytest.mark.parametrize("model", ["izhikevich", "adex"])
def test_neuron_kernel_plain_matches_reference(model, n, groups):
    """The plain twin (what K4/K5's wrapper runs on CPU tensors) against
    the reference's model step (eager jnp: one XLA op at a time, nothing
    contracted) and its Pallas kernel in interpret mode (jitted: XLA's CPU
    compiler contracts multiply-adds, ROADMAP Queue 3).  Spikes and
    ref_count are exact.  Against the eager Izhikevich step every float is
    bitwise equal (same op order, no transcendental); torch's and XLA's
    exp differ by ulps, and contraction moves a cancelled sum by up to 53
    ulps of itself on these inputs, so the other floats are held within 8
    ulps of the largest magnitude of their array."""
    make, wrapper, ref_kernel, names = KERNELS[model]
    rng = np.random.default_rng(n + 7 * groups)
    ref_cls, cls, gs, state, inputs = make(rng, n, groups)
    ref_m, m = ref_nm.get_model(model), neuron_models.get_model(model)
    table = np.asarray(ref_m.make_param_table([ref_cls(**g) for g in gs],
                                              0.1))
    np.testing.assert_array_equal(
        m.make_param_table([cls(**g) for g in gs], 0.1,
                           device=CPU).numpy(), table)
    f32 = {k: v.astype(np.float32) for k, v in {**state, **inputs}.items()}
    rc = rng.integers(0, 3, n).astype(np.int32)
    gid = rng.integers(0, groups, n).astype(np.int32)
    v, x, se, si = (f32[k] for k in state)
    iex, iin = f32["input_ex"], f32["input_in"]

    launches = wrapper.launches
    out = wrapper(*map(torch.from_numpy, (v, x, se, si, rc, gid, iex, iin,
                                          table)))
    assert wrapper.launches == launches      # the plain path
    st = ref_nm.snn.NeuronState(
        v_m=jnp.asarray(v), syn_ex=jnp.asarray(se), syn_in=jnp.asarray(si),
        ref_count=jnp.asarray(rc), spike=jnp.zeros(n, bool),
        group_id=jnp.asarray(gid), extra={ref_m.extra_fields[0]:
                                          jnp.asarray(x)})
    r = ref_m.step(st, jnp.asarray(table), jnp.asarray(iex), jnp.asarray(iin))
    oracle = (r.v_m, r.extra[ref_m.extra_fields[0]], r.syn_ex, r.syn_in,
              r.ref_count, r.spike)
    pad = (-n) % 128         # the Pallas kernel needs N % nb == 0
    p = lambda a: jnp.asarray(np.pad(a, (0, pad)))
    kern = [np.asarray(o)[:n] for o in ref_kernel(
        *map(p, (v, x, se, si, rc, gid, iex, iin)), jnp.asarray(table),
        nb=128, interpret=True)]

    assert np.asarray(oracle[5]).any(), "no spikes - vacuous"
    assert np.asarray(rc > 0).any() and np.asarray(oracle[4] > 0).any()
    for ref_out in (oracle, kern):
        exact = model == "izhikevich" and ref_out is oracle
        for name, a, b in zip(names, out, ref_out):
            a, b = a.numpy(), np.asarray(b)
            if exact or name in ("ref_count", "spike"):
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                np.testing.assert_allclose(
                    a, b, rtol=8 * F32_ULP_AT_1,
                    atol=8 * F32_ULP_AT_1 * float(np.abs(b).max()),
                    err_msg=name)


def test_adex_clamp_keeps_an_overshot_membrane_finite():
    """The reference's float32 policy (``tests/test_neuron_models.py::
    test_adex_fp32_clamp_keeps_dynamics_finite``): a membrane far above
    ``v_t + 10 delta_t`` stays finite - unclamped, exp overflows."""
    m = neuron_models.get_model("adex")
    g = [neuron_models.AdExParams(i_e=2000.0)]
    table = m.make_param_table(g, 0.1, device=CPU)
    st = m.init_state(64, np.zeros(64, np.int32), g, device=CPU)
    st = dataclasses.replace(st, v_m=torch.full((64,), 1e6))
    assert not torch.isfinite(torch.exp((st.v_m - g[0].v_t)
                                        / g[0].delta_t)).all()
    z = torch.zeros(64)
    spikes = 0
    for _ in range(200):
        st = m.step(st, table, z, z)
        spikes += int(st.spike.sum())
    assert torch.isfinite(st.v_m).all()
    assert torch.isfinite(st.extra["w_ad"]).all()
    assert spikes >= 64         # the overshot membrane spikes and resets


# --------------------------------------------------------------------------
# tables and initial state
# --------------------------------------------------------------------------

def _groups(model, ref):
    nm = ref_nm if ref else neuron_models
    return {
        "izhikevich": [nm.IzhikevichParams(), nm.IzhikevichParams(
            a=0.1, b=0.25, c=-55.0, t_ref=1.0)],
        "adex": [nm.AdExParams(), nm.AdExParams(t_ref=0.0, b=20.0,
                                                e_l=-65.3)],
        "poisson": [nm.PoissonParams(25.0), nm.PoissonParams(2e5)],
        "lif+poisson": [nm.snn.LIFParams(tau_m=8.0),
                        nm.PoissonParams(40.0)],
        "izhikevich+poisson": [nm.PoissonParams(7.0),
                               nm.IzhikevichParams(b=0.3)],
    }[model]


@pytest.mark.parametrize("model", ["izhikevich", "adex", "poisson",
                                   "lif+poisson", "izhikevich+poisson"])
def test_tables_and_initial_state_equal_reference(model):
    ref_m, m = ref_nm.get_model(model), neuron_models.get_model(model)
    assert m.name == ref_m.name and m.stochastic == ref_m.stochastic
    assert m.extra_fields == ref_m.extra_fields
    gid = np.random.default_rng(0).integers(0, 2, 50).astype(np.int32)
    ref_t = np.asarray(ref_m.make_param_table(_groups(model, True), 0.1))
    t = m.make_param_table(_groups(model, False), 0.1, device=CPU)
    np.testing.assert_array_equal(t.numpy(), ref_t)
    assert t.is_contiguous()
    ref_st = ref_m.init_state(50, gid, _groups(model, True))
    st = m.init_state(50, gid, _groups(model, False), device=CPU)
    m.check_state(st)
    for name in ("v_m", "syn_ex", "syn_in", "ref_count", "spike",
                 "group_id"):
        a, b = getattr(st, name).numpy(), np.asarray(getattr(ref_st, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert set(st.extra) == set(ref_st.extra)
    for k in st.extra:
        np.testing.assert_array_equal(st.extra[k].numpy(),
                                      np.asarray(ref_st.extra[k]))


def test_registry_contents_and_errors():
    assert neuron_models.available_models() == ref_nm.available_models()
    before = neuron_models.available_models()
    a = neuron_models.get_model("adex+poisson")
    assert a is neuron_models.get_model("adex+poisson")
    assert a.stochastic and a.kernel_step is not None
    assert neuron_models.available_models() == before
    assert neuron_models.get_model("poisson").kernel_step is None
    with pytest.raises(ValueError, match="unknown neuron model"):
        neuron_models.get_model("hodgkin-huxley")
    with pytest.raises(ValueError, match="stochastic base"):
        neuron_models.get_model("poisson+poisson")
    with pytest.raises(ValueError, match="already registered"):
        neuron_models.register_model("lif", neuron_models.LIFModel())
    with pytest.raises(TypeError, match="IzhikevichParams"):
        neuron_models.get_model("izhikevich").make_param_table(
            [neuron_models.snn.LIFParams()], 0.1, device=CPU)
    m = neuron_models.get_model("izhikevich")
    g = [neuron_models.IzhikevichParams()]
    st = m.init_state(4, np.zeros(4, np.int32), g, device=CPU)
    # surrogate mode: float spikes equal to the bool ones (two of the four
    # neurons start past v_peak, so both values occur)
    tbl = m.make_param_table(g, 0.1, device=CPU)
    near = dataclasses.replace(st, v_m=torch.tensor([20.0, 31.0, 35.0,
                                                     -60.0]))
    hard = m.step(near, tbl, torch.zeros(4), torch.zeros(4))
    soft = m.step(near, tbl, torch.zeros(4), torch.zeros(4), surrogate="st")
    assert hard.spike.dtype == torch.bool
    assert soft.spike.dtype == torch.float32
    assert hard.spike.any() and not hard.spike.all()
    assert torch.equal(soft.spike, hard.spike.to(torch.float32))
    assert torch.equal(soft.v_m, hard.v_m)
    p = neuron_models.get_model("poisson")
    pg = [neuron_models.PoissonParams()]
    with pytest.raises(ValueError, match="does not support surrogate"):
        p.step(p.init_state(4, np.zeros(4, np.int32), pg, device=CPU),
               p.make_param_table(pg, 0.1, device=CPU), torch.zeros(4),
               torch.zeros(4), uniform=torch.zeros(4), surrogate="st")
    with pytest.raises(ValueError, match="current-based"):
        m.step(st, m.make_param_table(g, 0.1, device=CPU), torch.zeros(4),
               torch.zeros(4), synapse_model="cond_exp")


# --------------------------------------------------------------------------
# trajectories per model (the reference's cross-backend test)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("model", MODELS)
def test_trajectory_per_model_matches_reference(model):
    """``model_demo(model, 0.004)``, 120 steps, drive off, STDP on where
    the network has plastic edges: the port's flat and cuda (plain twins)
    give the spike raster of the reference's flat and pallas; weights
    within 1e-4 and v_m within 1e-3 (the reference's own tolerances)."""
    n_steps, stdp_on = 120, model != "poisson"
    ref_spec, ref_stdp = ref_models.model_demo(model, 0.004, stdp=stdp_on)
    g_ref = ref_builder.build_shards(ref_spec,
                                     ref_builder.decompose(ref_spec, 1))[0]
    gd = g_ref.device_arrays()
    ref_table = ref_nm.get_model(model).make_param_table(
        list(ref_spec.groups), dt=0.1)
    ref_out = {}
    for sweep in ("flat", "pallas"):
        cfg = ref_engine.EngineConfig(dt=0.1, stdp=ref_stdp, sweep=sweep,
                                      external_drive=False,
                                      neuron_model=model)
        st_ref = ref_engine.init_state(gd, list(ref_spec.groups),
                                       jax.random.key(0), neuron_model=model)
        fin, sp = jax.jit(lambda s: ref_engine.run(s, gd, ref_table, cfg,
                                                   n_steps))(st_ref)
        ref_out[sweep] = (np.asarray(sp), np.asarray(fin.weights),
                          np.asarray(fin.neurons.v_m))
    uniform = (_ref_draws(st_ref, gd, n_steps)
               if neuron_models.get_model(model).stochastic else None)

    spec, stdp = models.model_demo(model, 0.004, stdp=stdp_on)
    assert spec.neuron_model == model
    g = _port_graph(g_ref)
    table = neuron_models.get_model(model).make_param_table(
        list(spec.groups), 0.1, device=CPU)
    np.testing.assert_array_equal(table.numpy(), np.asarray(ref_table))
    s_ref = ref_out["flat"][0]
    assert s_ref.sum() > 10, f"vacuous: {model} demo net barely spiked"
    for sweep in ("flat", "cuda"):
        cfg = engine.EngineConfig(dt=0.1, stdp=stdp, sweep=sweep,
                                  external_drive=False, neuron_model=model)
        st = engine.init_state(g, list(spec.groups), 0, neuron_model=model,
                               device=CPU)
        fin, sp = engine.run(st, g, table, cfg, n_steps,
                             model_uniform=uniform, device=CPU)
        for ref_sweep, (s_r, w_r, v_r) in ref_out.items():
            msg = f"{model}: port {sweep} vs reference {ref_sweep}"
            np.testing.assert_array_equal(sp.numpy(), s_r, err_msg=msg)
            np.testing.assert_allclose(fin.weights.numpy(), w_r, atol=1e-4,
                                       err_msg=msg)
            np.testing.assert_allclose(fin.neurons.v_m.numpy(), v_r,
                                       atol=1e-3, err_msg=msg)


def test_composite_matches_reference_with_its_draws():
    """``brunel(0.01, poisson_input=True)`` ("lif+poisson"), 200 steps:
    with the reference's emitter draws injected, the port's cuda and flat
    rasters equal the reference's flat raster."""
    n_steps = 200
    ref_spec, _ = ref_models.brunel(0.01, poisson_input=True)
    g_ref = ref_builder.build_shards(ref_spec,
                                     ref_builder.decompose(ref_spec, 1))[0]
    gd = g_ref.device_arrays()
    name = ref_spec.neuron_model
    ref_table = ref_nm.get_model(name).make_param_table(
        list(ref_spec.groups), dt=0.1)
    cfg_ref = ref_engine.EngineConfig(dt=0.1, external_drive=False,
                                      neuron_model=name)
    st_ref = ref_engine.init_state(gd, list(ref_spec.groups),
                                   jax.random.key(1), neuron_model=name)
    _, s_ref = jax.jit(lambda s: ref_engine.run(s, gd, ref_table, cfg_ref,
                                                n_steps))(st_ref)
    s_ref = np.asarray(s_ref)
    uniform = _ref_draws(st_ref, gd, n_steps)

    spec, _ = models.brunel(0.01, poisson_input=True)
    assert spec.neuron_model == name == "lif+poisson"
    g = _port_graph(g_ref)
    table = neuron_models.get_model(name).make_param_table(
        list(spec.groups), 0.1, device=CPU)
    off = spec.pop_offsets()
    assert s_ref[:, off[2]:off[3]].sum() > 100, "emitters silent"
    assert s_ref[:, off[0]:off[1]].sum() > 10, "drive did not propagate"
    for sweep in ("cuda", "flat"):
        cfg = engine.EngineConfig(dt=0.1, external_drive=False, sweep=sweep,
                                  neuron_model=name)
        st = engine.init_state(g, list(spec.groups), 1, neuron_model=name,
                               device=CPU)
        _, sp = engine.run(st, g, table, cfg, n_steps, model_uniform=uniform,
                           device=CPU)
        np.testing.assert_array_equal(sp.numpy(), s_ref, err_msg=sweep)


# --------------------------------------------------------------------------
# the port's own draws
# --------------------------------------------------------------------------

def test_own_draws_follow_the_neuron_not_the_row():
    gid = torch.arange(-1, 999, dtype=torch.int32)
    perm = torch.randperm(gid.numel(), generator=torch.Generator()
                          .manual_seed(0))
    t = torch.tensor(17, dtype=torch.int32)
    u = neuron_models.gid_uniform(5, t, gid)
    assert u.dtype == torch.float32 and u.shape == gid.shape
    assert ((u >= 0) & (u < 1)).all()
    assert torch.equal(neuron_models.gid_uniform(5, t, gid[perm]), u[perm])
    assert torch.equal(neuron_models.gid_uniform(5, 17, gid[:10]), u[:10])
    assert not torch.equal(neuron_models.gid_uniform(5, t + 1, gid), u)
    assert not torch.equal(neuron_models.gid_uniform(6, t, gid), u)
    # two shards of one network draw what one shard draws
    halves = [neuron_models.gid_uniform(5, t, gid[perm[i::2]])
              for i in (0, 1)]
    assert torch.equal(halves[0], u[perm[0::2]])
    assert torch.equal(halves[1], u[perm[1::2]])


def test_own_draws_fire_at_the_rate():
    """The poisson model on its own draws, 2000 steps of 512 emitters at
    400 Hz: the spike count within 4 sigma of its binomial mean."""
    m = neuron_models.get_model("poisson")
    groups = [neuron_models.PoissonParams(rate_hz=400.0)]
    table = m.make_param_table(groups, 0.1, device=CPU)
    st = m.init_state(512, np.zeros(512, np.int32), groups, device=CPU)
    gid = torch.arange(512, dtype=torch.int32)
    total = 0
    for t in range(2000):
        st = m.step(st, table, None, None, seed=3,
                    t=torch.tensor(t, dtype=torch.int32), gid=gid)
        total += int(st.spike.sum())
    n, p = 512 * 2000, float(table[0, 0])
    assert abs(total - n * p) < 4 * np.sqrt(n * p * (1 - p)), total
    with pytest.raises(ValueError, match="stochastic"):
        m.step(st, table, None, None)


def test_composite_on_own_draws_freezes_emitters():
    """``brunel(0.01, poisson_input=True)`` on the engine's own draws for
    300 steps: emitters fire at their rate (4 sigma), their state stays
    at its initial value, the drive reaches the LIF populations, and the
    kernel and flat backends agree."""
    spec, _ = models.brunel(0.01, poisson_input=True)
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(CPU)
    name = spec.neuron_model
    table = neuron_models.get_model(name).make_param_table(
        list(spec.groups), 0.1, device=CPU)
    out = {}
    for sweep in ("cuda", "flat"):
        cfg = engine.EngineConfig(dt=0.1, external_drive=False, sweep=sweep,
                                  neuron_model=name)
        st = engine.init_state(g, list(spec.groups), 7, neuron_model=name,
                               device=CPU)
        assert st.model_seed == 7
        out[sweep] = engine.run(st, g, table, cfg, 300, device=CPU)
        assert st.neurons.v_m.data_ptr() != out[sweep][0].neurons.v_m \
            .data_ptr()
    (fin, sp), (_, sp_flat) = out["cuda"], out["flat"]
    assert torch.equal(sp, sp_flat)
    off = spec.pop_offsets()
    emit = slice(off[2], off[3])
    n, p = sp[:, emit].numel(), float(table[1, -1])
    assert abs(int(sp[:, emit].sum()) - n * p) < 4 * np.sqrt(n * p * (1 - p))
    assert sp[:, off[0]:off[1]].sum() > 10, "drive did not propagate"
    init = engine.init_state(g, list(spec.groups), 7, neuron_model=name,
                             device=CPU).neurons
    for f in ("v_m", "syn_ex", "syn_in", "ref_count"):
        assert torch.equal(getattr(fin.neurons, f)[emit],
                           getattr(init, f)[emit]), f


# --------------------------------------------------------------------------
# scenarios
# --------------------------------------------------------------------------

def _assert_same(name, a, b):
    if a is None or b is None:
        assert a is None and b is None, name
    elif isinstance(a, (int, np.integer)):
        assert int(a) == int(b), name
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)


SCENARIOS = [  # (factory name, args, kwargs, shards)
    ("brunel", (0.02,), {}, 1),
    ("brunel", (0.02,), {"poisson_input": True}, 1),
    ("microcircuit", (0.01,), {}, 1),
    *[("model_demo", (m, 0.004), {}, 1) for m in MODELS],
    ("marmoset", (0.004,), {"n_areas": 4}, 4),
]


@pytest.mark.parametrize("connectivity", ["materialized", "procedural"])
@pytest.mark.parametrize("factory,args,kwargs,shards", SCENARIOS)
def test_scenario_builds_equal_reference(factory, args, kwargs, shards,
                                         connectivity):
    def spec_of(mod):
        out = getattr(mod, factory)(*args, **kwargs)
        spec = out if factory == "marmoset" else out[0]
        return dataclasses.replace(spec, connectivity=connectivity)

    ref_spec, spec = spec_of(ref_models), spec_of(models)
    assert models.scenario_id(spec) == ref_models.scenario_id(ref_spec)
    d = builder.spec_to_dict(spec)
    assert d == ref_builder.spec_to_dict(ref_spec)
    assert builder.spec_to_dict(builder.spec_from_dict(d)) == d
    ref_dec = ref_builder.decompose(ref_spec, shards)
    dec = builder.decompose(spec, shards)
    ref_shards = ref_builder.build_shards(ref_spec, ref_dec)
    shards_ = builder.build_shards(spec, dec)
    assert len(shards_) == len(ref_shards) == shards
    for rg, g in zip(ref_shards, shards_):
        for f in dataclasses.fields(g):
            if f.name != "blocked":
                _assert_same(f.name, getattr(rg, f.name), getattr(g, f.name))
        for f in dataclasses.fields(BlockedGraph):
            _assert_same(f"blocked.{f.name}", getattr(rg.blocked, f.name),
                         getattr(g.blocked, f.name))


def test_scenario_registry_equals_reference():
    assert models.available_scenarios() == ref_models.available_scenarios()
    for name in models.available_scenarios():
        spec, stdp = models.get_scenario(name)
        ref_spec, ref_stdp = ref_models.get_scenario(name)
        assert models.scenario_id(spec) == ref_models.scenario_id(ref_spec)
        assert (stdp is None) == (ref_stdp is None), name
        _, _, sid = models.resolve_scenario(name)
        assert sid == models.scenario_id(spec)
    spec, _ = models.get_scenario("brunel", scale=0.01, eta=1.5,
                                  poisson_input=True)
    ref_spec, _ = ref_models.get_scenario("brunel", scale=0.01, eta=1.5,
                                          poisson_input=True)
    assert models.scenario_id(spec) == ref_models.scenario_id(ref_spec)
    assert models.resolve_scenario(spec)[2] == models.scenario_id(spec)
    with pytest.raises(ValueError, match="unknown scenario"):
        models.get_scenario("allen-v1")
    with pytest.raises(TypeError, match="only stdp"):
        models.resolve_scenario(spec, scale=2.0)
    with pytest.raises(ValueError, match="no demo parameterization"):
        models.model_demo("hodgkin-huxley")


# --------------------------------------------------------------------------
# struct check and carrying states across
# --------------------------------------------------------------------------

def test_engine_rejects_a_state_of_another_model():
    spec, _ = models.model_demo("izhikevich", 0.004)
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(CPU)
    m = neuron_models.get_model("izhikevich")
    table = m.make_param_table(list(spec.groups), 0.1, device=CPU)
    st = engine.init_state(g, list(spec.groups), 0, neuron_model="izhikevich",
                           device=CPU)
    with pytest.raises(ValueError, match="state was initialized for "
                                         "neuron_model='izhikevich'"):
        engine.engine_step(st, g, table, engine.EngineConfig(
            external_drive=False, sweep="flat"))
    # a forged marker does not get past the struct check either
    forged = dataclasses.replace(st, neuron_model="adex")
    with pytest.raises(ValueError, match="different neuron_model"):
        engine.engine_step(forged, g, table, engine.EngineConfig(
            external_drive=False, sweep="flat", neuron_model="adex"))
    with pytest.raises(ValueError, match="model_uniform must be"):
        engine.run(st, g, table, engine.EngineConfig(
            external_drive=False, sweep="flat", neuron_model="izhikevich"), 3,
            model_uniform=torch.zeros(2, g.n_local), device=CPU)


@pytest.mark.parametrize("model", ["izhikevich", "adex", "poisson"])
def test_state_from_reference_round_trips(model):
    ref_spec, _ = ref_models.model_demo(model, 0.004, stdp=True)
    g_ref = ref_builder.build_shards(ref_spec,
                                     ref_builder.decompose(ref_spec, 1))[0]
    st_ref = ref_engine.init_state(g_ref.device_arrays(),
                                   list(ref_spec.groups), jax.random.key(0),
                                   neuron_model=model)
    rng = np.random.default_rng(3)
    leaves = {
        "neurons.v_m": rng.uniform(-70, 20, g_ref.n_local),
        "neurons.syn_ex": np.asarray(st_ref.neurons.syn_ex),
        "neurons.syn_in": np.asarray(st_ref.neurons.syn_in),
        "neurons.ref_count": rng.integers(0, 3, g_ref.n_local),
        "neurons.spike": rng.uniform(size=g_ref.n_local) < 0.3,
        "ring": np.asarray(st_ref.ring), "weights": np.asarray(st_ref.weights),
        "traces.k_pre": np.asarray(st_ref.traces.k_pre),
        "traces.k_post": np.asarray(st_ref.traces.k_post),
        "t": np.asarray(st_ref.t),
        "gate_overflow": np.asarray(st_ref.gate_overflow)}
    for k, v in st_ref.neurons.extra.items():
        leaves[f"neurons.extra.{k}"] = np.asarray(v) + rng.uniform(
            -1, 1, g_ref.n_local).astype(np.float32)
    leaves["neurons.v_m"] = leaves["neurons.v_m"].astype(np.float32)
    leaves["neurons.ref_count"] = leaves["neurons.ref_count"].astype(np.int32)
    assert set(leaves) == set(convert.state_leaves(model))
    g = _port_graph(g_ref)
    for sweep in ("cuda", "flat"):
        st = convert.state_from_numpy(leaves, g, sweep=sweep, device=CPU,
                                      seed=4, neuron_model=model)
        assert st.neuron_model == model
        assert st.model_seed == (4 if model == "poisson" else None)
        back = convert.state_to_numpy(st, g)
        assert set(back) == set(leaves)
        for k, v in leaves.items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)
    with pytest.raises(KeyError, match="lack"):
        convert.state_from_numpy(
            {k: v for k, v in leaves.items() if k != "neurons.v_m"}, g,
            sweep="flat", device=CPU, neuron_model=model)
    if st_ref.neurons.extra:     # a LIF state is not an izhikevich state
        with pytest.raises(KeyError, match="neurons.extra"):
            convert.state_from_numpy(
                {k: v for k, v in leaves.items() if "extra" not in k}, g,
                sweep="flat", device=CPU, neuron_model=model)
