"""K1 with the neuron update as its epilogue (K1 + K2, K1 + K4, K1 + K5),
on the CPU.

* the fused wrapper's plain twin against the reference: its Pallas
  ``synaptic_gather`` (interpret mode, as ``tests/test_kernels.py`` runs
  it), ``+ drive``, then its Pallas ``lif_step_kernel``,
  ``izhikevich_step_kernel`` or ``adex_step_kernel`` (interpret mode,
  padded to the kernel's block), on seeded numpy inputs handed to both;
* the engine's step with the drive drawn before the sweep: ``"cuda"`` (the
  kernels' plain twins here) against ``"flat"``, and the generator's stream
  unchanged;
* which route ``sweep_update`` takes, by (backend, model, synapse model).

The fused CUDA kernel itself needs the card: ``tests/test_torch_gpu.py``
holds it against its twin and against K1 -> add -> K2/K4/K5 there.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import neuron_models as ref_nm
from repro.core import snn as ref_snn
from repro.kernels.adex_step import adex_step_kernel as ref_adex_kernel
from repro.kernels.izhikevich_step import \
    izhikevich_step_kernel as ref_izh_kernel
from repro.kernels.lif_step import lif_step_kernel as ref_lif_kernel
from repro.kernels.synaptic_gather import synaptic_gather as ref_gather
from repro_torch.core import backends, builder, engine, models, neuron_models
from repro_torch.core import snn
from repro_torch.kernels import synaptic_gather as gather_mod

CPU = "cpu"
F32_ULP_AT_1 = 2.0 ** -23
#: the row sums of the reference's one-hot matmul and of the twin's
#: index_add_ add ~100 terms of |w| ~ 50 in different orders (the stated
#: tolerance of tests/test_torch_kernels.py::test_gather_plain_matches_pallas)
SUM_ATOL = 1e-3
#: XLA's CPU compiler contracts the Pallas LIF kernel's multiply-adds (the
#: stated tolerance of tests/test_torch_kernels.py::
#: test_lif_plain_matches_pallas)
LIF_ATOL = 1e-4

# nb, eb, pb, m, d_max, t, n_local: n_local ragged inside the last block
SHAPES = [(2, 256, 64, 150, 8, 5, 113), (3, 128, 32, 80, 4, 11, 71)]
MODELS = [("lif", False), ("lif", True), ("izhikevich", False),
          ("adex", False)]


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


def neuron_inputs(rng, neuron, n):
    """Seeded state (in ``NEURON_STATE`` order), group ids and the
    reference's table for 3 groups: LIF around its threshold, Izhikevich up
    to v_peak, AdEx up to the exponential's clamp (v_t + 10 delta_t), so
    that some neurons spike; half of them refractory."""
    f32 = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)
    rc = rng.integers(0, 2, n).astype(np.int32)
    gid = rng.integers(0, 3, n).astype(np.int32)
    if neuron == "lif":
        gs = [ref_snn.LIFParams(tau_m=10.0 + 5 * i, t_ref=0.5 + i,
                                tau_syn_ex=0.5 + 0.2 * i) for i in range(3)]
        table = np.asarray(ref_snn.make_param_table(gs, dt=0.1))
        state = (f32(-52, -48), f32(0, 100), f32(-100, 100), rc)
    elif neuron == "izhikevich":
        gs = [ref_nm.IzhikevichParams(a=0.02 + 0.04 * i, d=8.0 - 3 * i,
                                      i_e=5.0 * i, t_ref=0.3 * i,
                                      i_scale=1.0 - 0.2 * i)
              for i in range(3)]
        table = np.asarray(ref_nm.get_model("izhikevich").make_param_table(
            gs, 0.1))
        state = (f32(-70, 30), f32(-16, 0), f32(0, 30), f32(-30, 0), rc)
    else:
        gs = [ref_nm.AdExParams(i_e=400.0 * i, a=4.0 + 2 * i,
                                t_ref=2.0 - 0.7 * i) for i in range(3)]
        table = np.asarray(ref_nm.get_model("adex").make_param_table(gs,
                                                                     0.1))
        state = (f32(-60, -30), f32(0, 100), f32(0, 300), f32(-300, 0), rc)
    return state, gid, table.astype(np.float32)


@pytest.mark.parametrize("with_drive", [False, True])
@pytest.mark.parametrize("neuron,cond", MODELS)
@pytest.mark.parametrize("nb,eb,pb,m,d_max,t,n", SHAPES)
def test_fused_plain_matches_reference(nb, eb, pb, m, d_max, t, n, neuron,
                                       cond, with_drive):
    """Spikes, ref_count and arrivals exact.  The membrane (and
    Izhikevich's u, AdEx's w_ad) does not depend on this step's input:
    within the neuron kernel's own stated tolerance, LIF_ATOL for LIF and,
    for Izhikevich and AdEx, 8 ulps of the largest magnitude
    (tests/test_torch_zoo.py::test_neuron_kernel_plain_matches_reference:
    exp's ulps and XLA's contraction); Izhikevich's v and u are bitwise
    the reference's eager step (no contraction, no transcendental).  The
    synaptic state adds the row sums: SUM_ATOL on top."""
    rng = np.random.default_rng(nb * 131 + eb + n + 7 * cond
                                + 3 * with_drive + len(neuron))
    pre, post, w, delay, chan = sorted_blocked(rng, nb, eb, pb, m, d_max)
    ring = (rng.uniform(size=(d_max, m)) < 0.3).astype(np.float32)
    state, gid, table = neuron_inputs(rng, neuron, n)
    drive = rng.uniform(0, 300, n).astype(np.float32) if with_drive else None

    ex_r, in_r, arr_r = ref_gather(
        *map(jnp.asarray, (pre, post, w, delay, chan, ring)),
        jnp.asarray(t, jnp.int32), max_delay=d_max, pb=pb, interpret=True,
        emit_arrivals=True)
    ex_r, in_r = ex_r[:n], in_r[:n]
    if drive is not None:
        ex_r = ex_r + jnp.asarray(drive)
    pad = (-n) % 128     # the Pallas neuron kernels need N % nb == 0
    padj = lambda x: jnp.asarray(np.pad(np.asarray(x), (0, pad)))
    args = (*map(padj, state), padj(gid), padj(ex_r), padj(in_r))
    if neuron == "lif":
        out_r = ref_lif_kernel(*args, jnp.asarray(table), cond=cond, nb=128,
                               interpret=True)
    else:
        ref_kernel = (ref_izh_kernel if neuron == "izhikevich"
                      else ref_adex_kernel)
        out_r = ref_kernel(*args, jnp.asarray(table), nb=128, interpret=True)

    th = lambda x: None if x is None else torch.from_numpy(x)
    edge = [torch.from_numpy(x) for x in (pre, post, w, delay, chan, ring)]
    kw = dict(neuron=neuron, cond=cond, max_delay=d_max, pb=pb,
              drive=th(drive))
    launches = gather_mod.synaptic_gather_update.launches
    arr, out = gather_mod.synaptic_gather_update(
        *edge, torch.tensor(t, dtype=torch.int32), tuple(map(th, state)),
        th(gid), th(table), **kw)
    assert gather_mod.synaptic_gather_update.launches == launches  # plain
    arr_p, out_p = gather_mod.synaptic_gather_update_plain(
        *edge, t, tuple(map(th, state)), th(gid), th(table), **kw)
    assert torch.equal(arr, arr_p)
    assert all(torch.equal(a, b) for a, b in zip(out, out_p))

    np.testing.assert_array_equal(arr.numpy(), np.asarray(arr_r))
    names = gather_mod.NEURON_STATE[neuron][0] + ("spike",)
    assert len(out) == len(out_r) == len(names)
    assert np.asarray(out_r[-1])[:n].any(), "no spikes - vacuous"
    assert (state[-1] > 0).any(), "no refractory neuron - vacuous"
    for name, p, r in zip(names, out, out_r):
        p, r = p.numpy(), np.asarray(r)[:n]
        if name in ("ref_count", "spike"):
            np.testing.assert_array_equal(p, r, err_msg=name)
            continue
        atol = (LIF_ATOL if neuron == "lif"
                else 8 * F32_ULP_AT_1 * float(np.abs(r).max()))
        if name in ("syn_ex", "syn_in"):
            atol += SUM_ATOL
        np.testing.assert_allclose(
            p, r, rtol=0 if neuron == "lif" else 8 * F32_ULP_AT_1,
            atol=atol, err_msg=name)
    if neuron == "izhikevich":
        ref_m = ref_nm.get_model("izhikevich")
        st = ref_nm.snn.NeuronState(
            v_m=jnp.asarray(state[0]), syn_ex=jnp.asarray(state[2]),
            syn_in=jnp.asarray(state[3]), ref_count=jnp.asarray(state[4]),
            spike=jnp.zeros(n, bool), group_id=jnp.asarray(gid),
            extra={"u": jnp.asarray(state[1])})
        eager = ref_m.step(st, jnp.asarray(table), ex_r, in_r)
        np.testing.assert_array_equal(out[0].numpy(), np.asarray(eager.v_m))
        np.testing.assert_array_equal(out[1].numpy(),
                                      np.asarray(eager.extra["u"]))


def test_fused_wrapper_rejects_what_it_cannot_step():
    rng = np.random.default_rng(0)
    edge = [torch.from_numpy(x) for x in sorted_blocked(rng, 1, 64, 32, 20,
                                                        4)]
    ring = torch.zeros((4, 20))
    state, gid, table = neuron_inputs(rng, "adex", 32)
    th = lambda x: torch.from_numpy(x)
    with pytest.raises(ValueError, match="conductance"):
        gather_mod.synaptic_gather_update(
            *edge, ring, 0, tuple(map(th, state)), th(gid), th(table),
            neuron="adex", cond=True, max_delay=4, pb=32)
    with pytest.raises(ValueError, match="state is"):
        gather_mod.synaptic_gather_update(
            *edge, ring, 0, tuple(map(th, state))[:4], th(gid), th(table),
            neuron="adex", max_delay=4, pb=32)
    with pytest.raises(ValueError, match="neuron must be"):
        gather_mod.synaptic_gather_update(
            *edge, ring, 0, tuple(map(th, state)), th(gid), th(table),
            neuron="poisson", max_delay=4, pb=32)
    state, gid, table = neuron_inputs(rng, "izhikevich", 32)
    with pytest.raises(ValueError, match="conductance"):
        gather_mod.synaptic_gather_update(
            *edge, ring, 0, tuple(map(th, state)), th(gid), th(table),
            neuron="izhikevich", cond=True, max_delay=4, pb=32)


# --------------------------------------------------------------------------
# the engine: drive first, then one sweep_update
# --------------------------------------------------------------------------

def _hpc(scale=0.02):
    spec, stdp = models.hpc_benchmark(scale, stdp=True)
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(CPU)
    table = snn.make_param_table(list(spec.groups), 0.1, device=CPU)
    return spec, stdp, g, table


def _state_near_threshold(g, spec, seed, sweep=None):
    """A fresh state whose membranes are drawn around threshold (from rest
    scale 0.02 is silent for ~100 steps)."""
    st = engine.init_state(g, list(spec.groups), seed, sweep=sweep,
                           device=CPU)
    v0 = np.random.default_rng(seed + 1).uniform(-56.0, -45.0, g.n_local)
    return dataclasses.replace(st, neurons=dataclasses.replace(
        st.neurons, v_m=torch.from_numpy(v0.astype(np.float32))))


def test_engine_cuda_twins_equal_flat_with_the_drive_on():
    """hpc_benchmark(0.02), 120 steps, the engine's own Poisson drive: the
    kernel backend (fused LIF route, plain twins here) and the flat backend
    give the same spikes; voltages within LIF_ATOL and weights within 1e-4
    (the two sum the rows in different orders, as
    tests/test_torch_engine.py's parity tests state)."""
    spec, stdp, g, table = _hpc()
    assert backends.get_backend("cuda").update_route(
        "lif", snn.SynapseModel.CURRENT_EXP) == "fused:lif"
    runs = {}
    for sweep in ("cuda", "flat"):
        cfg = engine.EngineConfig(dt=0.1, stdp=stdp, sweep=sweep)
        runs[sweep] = engine.run(_state_near_threshold(g, spec, 4), g, table,
                                 cfg, 120, device=CPU)
    (fc, sc), (ff, sf) = runs["cuda"], runs["flat"]
    assert sf.sum() > 50, "nothing spiked - vacuous"
    assert torch.equal(sc, sf)
    torch.testing.assert_close(fc.neurons.v_m, ff.neurons.v_m, rtol=0,
                               atol=LIF_ATOL)
    torch.testing.assert_close(fc.weights, ff.weights, rtol=0, atol=1e-4)
    assert torch.equal(fc.neurons.ref_count, ff.neurons.ref_count)


def test_drive_first_keeps_the_generators_stream():
    """The drive is drawn before the sweep: a run on its own draws equals,
    spike for spike and bitwise in state, a run fed the drive drawn up
    front from a generator with the state's seed - the generator has no
    other consumer in a step."""
    spec, stdp, g, table = _hpc()
    cfg = engine.EngineConfig(dt=0.1, stdp=stdp, sweep="cuda")
    seed, n_steps = 9, 120
    own = [engine.run(_state_near_threshold(g, spec, seed), g, table, cfg,
                      n_steps, device=CPU) for _ in range(2)]
    gen = torch.Generator(device=CPU)
    gen.manual_seed(seed)
    lam = g.ext_rate * (cfg.dt * 1e-3)
    drive = torch.stack([g.ext_weight * torch.poisson(lam, generator=gen)
                         for _ in range(n_steps)])
    fed = engine.run(_state_near_threshold(g, spec, seed), g, table, cfg,
                     n_steps, drive=drive, device=CPU)
    assert own[0][1].sum() > 50, "nothing spiked - vacuous"
    for fin, spikes in (own[1], fed):
        assert torch.equal(spikes, own[0][1])
        assert torch.equal(fin.neurons.v_m, own[0][0].neurons.v_m)
        assert torch.equal(fin.weights, own[0][0].weights)


# --------------------------------------------------------------------------
# the route
# --------------------------------------------------------------------------

CUR, COND = snn.SynapseModel.CURRENT_EXP, snn.SynapseModel.COND_EXP
ROUTES = [  # backend, model, synapse model, route
    ("cuda", "lif", CUR, "fused:lif"),
    ("cuda", "lif", COND, "fused:lif"),
    ("cuda", None, CUR, "fused:lif"),
    ("cuda", "adex", CUR, "fused:adex"),
    ("cuda", "adex", COND, "composed"),
    ("cuda", "izhikevich", CUR, "fused:izhikevich"),
    ("cuda", "izhikevich", COND, "composed"),
    ("cuda", "lif+poisson", CUR, "composed"),
    ("cuda", "adex+poisson", CUR, "composed"),
    ("cuda", "poisson", CUR, "composed"),
    ("cuda:sparse", "lif", CUR, "composed"),
    ("cuda:sparse", "lif", COND, "composed"),
    ("cuda:sparse:1e-7", "adex", CUR, "composed"),
    ("cuda:sparse", "izhikevich", CUR, "composed"),
    ("flat", "lif", CUR, "composed"),
    ("flat", "adex", CUR, "composed"),
]


@pytest.mark.parametrize("sweep,model,synapse,route", ROUTES)
def test_update_route(sweep, model, synapse, route):
    backend = backends.get_backend(sweep)
    assert backend.update_route(model, synapse) == route
    m = None if model is None else neuron_models.get_model(model)
    assert backend.update_route(m, synapse) == route


@pytest.mark.parametrize("sweep,model,fused", [
    ("cuda", "lif", True), ("cuda", "adex", True),
    ("cuda", "izhikevich", True), ("cuda", "lif+poisson", False),
    ("cuda:sparse", "lif", False), ("cuda:sparse", "adex", False),
    ("cuda:sparse", "izhikevich", False),
    ("flat", "lif", False)])
def test_a_step_takes_its_route(monkeypatch, sweep, model, fused):
    """``engine_step`` calls the fused wrapper exactly on the fused routes,
    and there its result equals the composed route's bitwise (the plain
    twins here)."""
    spec, stdp = (models.hpc_benchmark(0.02, stdp=True) if model == "lif"
                  else models.get_scenario("brunel", scale=0.02,
                                           poisson_input=True)
                  if model == "lif+poisson"
                  else models.model_demo(model, 0.02, stdp=True))
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(CPU)
    nm = neuron_models.get_model(spec.neuron_model)
    table = nm.make_param_table(list(spec.groups), 0.1, device=CPU)
    cfg = engine.EngineConfig(dt=0.1, stdp=stdp, sweep=sweep,
                              neuron_model=spec.neuron_model)
    st = engine.init_state(g, list(spec.groups), 0, sweep=sweep,
                           neuron_model=spec.neuron_model, device=CPU)
    st, _ = engine.run(st, g, table, cfg, 30, device=CPU)   # some activity
    backend = backends.get_backend(sweep)
    st = engine.state_with_weights_layout(st, g, backend.weights_layout,
                                          backend=backend)
    weights = st.weights.clone()   # a gated step may update them in place
    calls = []
    real = gather_mod.synaptic_gather_update
    monkeypatch.setattr(backends, "synaptic_gather_update",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    gen_state = st.generator.get_state()
    new, spikes = engine.engine_step(st, g, table, cfg)
    assert len(calls) == (1 if fused else 0)

    st.generator.set_state(gen_state)
    drive = (None if g.ext_rate is None else
             engine._poisson_drive(st.generator, g, cfg.dt, torch.float32))
    composed = backends.SweepBackend.sweep_update(
        backend, backend.prepare(g), weights, st.ring, st.t, st.neurons, table, drive,
        synapse_model=cfg.synapse_model, model=nm, seed=st.model_seed,
        gid=g.global_id)[0]
    for name in ("v_m", "syn_ex", "syn_in", "ref_count", "spike"):
        assert torch.equal(getattr(new.neurons, name),
                           getattr(composed, name)), name
    for k in nm.extra_fields:
        assert torch.equal(new.neurons.extra[k], composed.extra[k]), k
