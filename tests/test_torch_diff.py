"""The port's differentiable simulation against the reference's
(``tests/test_diff.py``): the surrogate primitive in both AD modes, the
per-model gradchecks and Jacobians, surrogate mode's forward (bitwise
inference mode on ``"flat"`` and ``"cuda"``, and the reference's raster
under its own diffusion draws), the checkpointed rollout, the rollout's
gradient, and the grad guard of the kernel wrappers.

Gradcheck method (the reference's): central finite differences cannot see
a surrogate, so AD is checked against FD on ``sum(v_m)`` at states where
no neuron crosses threshold inside the stencil, and the spike leaf's
gradient as ``grad_fn(v_next - v_thr) * dv_next/dv`` with the second
factor by FD.  Everything runs on the CPU, where ``"cuda"`` runs its
kernels' plain twins.
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
from repro.core import snn as ref_snn
from repro.diff import rollout as ref_rollout
from repro.diff import surrogate as ref_surrogate
from repro_torch import convert
from repro_torch.core import builder, engine, models, neuron_models, snn
from repro_torch.diff import rollout, surrogate
from repro_torch.kernels import flash_attention as fa_kernels
from repro_torch.kernels import lif_step as lif_step_kernel_mod
from repro_torch.kernels import stdp_update as stdp_kernels
from repro_torch.kernels import synaptic_gather as gather_kernels

CPU = "cpu"
SURROGATE = "fast_sigmoid"
MODELS = ("adex", "izhikevich", "lif")


# --------------------------------------------------------------------------
# the surrogate primitive
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_surrogate_forward_is_exact_heaviside(dtype):
    fn = surrogate.get_surrogate("fast_sigmoid")
    x = torch.tensor([-2.0, -1e-6, 0.0, 1e-6, 3.0], dtype=dtype)
    out = fn(x)
    assert out.dtype == dtype
    assert out.tolist() == [0.0, 0.0, 1.0, 1.0, 1.0]


def _analytic(spec, x):
    name, _, arg = spec.partition(":")
    s = float(arg)
    return s / (1.0 + s * abs(x)) ** 2 if name == "fast_sigmoid" else (
        1.0 if abs(x) <= s else 0.0)


@pytest.mark.parametrize("spec", ["fast_sigmoid:2.0", "st:0.5"])
def test_surrogate_grads_both_modes_match_analytic_and_reference(spec):
    """Reverse mode (``torch.autograd.grad``, ``torch.func.grad``) and
    forward mode (``torch.func.jacfwd``) equal the analytic derivative and
    the reference's ``jax.grad`` / ``jax.jacfwd`` at the same points
    (rtol 1e-6, the reference's own bar)."""
    fn, ref_fn = surrogate.get_surrogate(spec), ref_surrogate.get_surrogate(
        spec)
    for x in (-1.5, -0.2, 0.3, 0.5, 0.7):
        xt = torch.tensor(x, requires_grad=True)
        (rev,) = torch.autograd.grad(fn(xt), xt)
        fwd = torch.func.jacfwd(fn)(torch.tensor(x))
        fgrad = torch.func.grad(fn)(torch.tensor(x))
        want = _analytic(spec, x)
        ref_rev = float(jax.grad(ref_fn)(x))
        ref_fwd = float(jax.jacfwd(ref_fn)(x))
        for got in (rev, fwd, fgrad):
            assert float(got) == pytest.approx(want, rel=1e-6, abs=0)
            assert float(got) == pytest.approx(ref_rev, rel=1e-6, abs=0)
            assert float(got) == pytest.approx(ref_fwd, rel=1e-6, abs=0)
    # a batch: vmap of grad and the diagonal of jacfwd agree elementwise
    xs = torch.linspace(-2.0, 2.0, 9)
    torch.testing.assert_close(torch.func.vmap(torch.func.grad(fn))(xs),
                               torch.func.jacfwd(fn)(xs).diagonal(),
                               rtol=0, atol=0)


def _message(fn, *args):
    with pytest.raises(ValueError) as err:
        fn(*args)
    return str(err.value)


def test_surrogate_spec_validation_matches_reference():
    assert (surrogate.available_surrogates()
            == ref_surrogate.available_surrogates() == ("fast_sigmoid", "st"))
    for spec, match in (("sigmoid", "unknown surrogate"),
                        ("st:wide", "not a float"),
                        ("fast_sigmoid:-1", "must be > 0")):
        got = _message(surrogate.get_surrogate, spec)
        assert match in got
        assert got == _message(ref_surrogate.get_surrogate, spec)
    assert surrogate.get_surrogate("st") is surrogate.get_surrogate("st")
    assert (surrogate.DEFAULT_ST_WIDTH, surrogate.DEFAULT_FS_BETA) == (
        ref_surrogate.DEFAULT_ST_WIDTH, ref_surrogate.DEFAULT_FS_BETA)


def test_poisson_rejects_a_surrogate_with_the_reference_message():
    for name in ("poisson", "lif+poisson"):
        got = _message(neuron_models.get_model(name).spike_fn, "st")
        assert "does not support surrogate" in got
        assert got == _message(ref_nm.get_model(name).spike_fn, "st")
    assert [neuron_models.get_model(m).supports_surrogate for m in MODELS] \
        == [True] * 3
    assert neuron_models.get_model("lif").spike_fn(None) is None


# --------------------------------------------------------------------------
# per-model gradchecks and Jacobians
# --------------------------------------------------------------------------

#: one sub-threshold tonic group per threshold model (the reference's)
_THRESH = {"lif": "v_th", "izhikevich": "v_peak", "adex": "v_peak"}


def _group(pkg, name):
    if name == "lif":
        return pkg.snn.LIFParams(i_e=300.0, t_ref=1.0)
    if name == "izhikevich":
        return pkg.neuron_models.IzhikevichParams(i_e=4.0)
    return pkg.neuron_models.AdExParams(i_e=200.0)


class _Port:
    snn, neuron_models = snn, neuron_models


class _Ref:
    snn, neuron_models = ref_snn, ref_nm


#: the dynamical instability point the setup stays 6-10 mV under
_SETUP_CEIL = {"lif": lambda p: p.v_th, "izhikevich": lambda p: -45.0,
               "adex": lambda p: p.v_t}


def _setup_arrays(name, n=8, seed=0):
    group = _group(_Port, name)
    rng = np.random.default_rng(seed)
    v = _SETUP_CEIL[name](group) - 6.0 - 4.0 * rng.uniform(size=n)
    return {"v_m": v.astype(np.float32),
            "syn_ex": (50.0 * rng.uniform(size=n)).astype(np.float32),
            "syn_in": (20.0 * rng.uniform(size=n)).astype(np.float32)}


def _port_setup(name, n=8):
    m = neuron_models.get_model(name)
    group = _group(_Port, name)
    table = m.make_param_table([group], dt=0.1, device=CPU)
    st = m.init_state(n, np.zeros(n, np.int32), [group], device=CPU)
    arr = {k: torch.from_numpy(v) for k, v in _setup_arrays(name, n).items()}
    return m, table, dataclasses.replace(st, **arr), group


def _ref_setup(name, n=8):
    m = ref_nm.get_model(name)
    group = _group(_Ref, name)
    table = jnp.asarray(m.make_param_table([group], dt=0.1))
    st = m.init_state(n, np.zeros(n, np.int32), [group])
    arr = {k: jnp.asarray(v) for k, v in _setup_arrays(name, n).items()}
    return m, table, dataclasses.replace(st, **arr)


def _central_fd(f, x, eps):
    """Dense central-difference Jacobian of vector ``f`` at ``x``, (out,
    in), in float64 from float32 evaluations."""
    x = x.double()
    cols = []
    for j in range(x.numel()):
        hi, lo = x.clone(), x.clone()
        hi[j] += eps
        lo[j] -= eps
        cols.append((f(hi.float()).double() - f(lo.float()).double())
                    / (2 * eps))
    return torch.stack(cols, dim=1)


@pytest.mark.parametrize("name", MODELS)
def test_smooth_vm_grads_match_fd(name):
    """AD through the surrogate-mode step == central FD of ``v_m`` at a
    sub-threshold state, over one step (the membrane) and two (the input
    reaching v through the synapse); the reference's tolerances."""
    m, table, st, _ = _port_setup(name)
    zero = torch.zeros(st.v_m.shape[0])

    def v_after(v):
        s = dataclasses.replace(st, v_m=v)
        return m.step(s, table, zero, zero, surrogate=SURROGATE).v_m

    ad = torch.func.jacrev(v_after)(st.v_m)
    fd = _central_fd(v_after, st.v_m, eps=0.05)
    np.testing.assert_allclose(ad.numpy(), fd.numpy(), rtol=5e-2, atol=1e-4)

    def v_two_steps(inp):
        s = m.step(st, table, inp, zero, surrogate=SURROGATE)
        return m.step(s, table, zero, zero, surrogate=SURROGATE).v_m

    inp0 = torch.full_like(zero, 30.0)
    ad_in = torch.func.jacrev(v_two_steps)(inp0)
    fd_in = _central_fd(v_two_steps, inp0, eps=1.0)
    np.testing.assert_allclose(ad_in.numpy(), fd_in.numpy(), rtol=5e-2,
                               atol=1e-5)
    assert ad_in.abs().max() > 0


@pytest.mark.parametrize("name", MODELS)
def test_spike_leaf_grad_is_surrogate_times_fd(name):
    """d spike / d v_m == grad_fn(v_next - v_thr) * d v_next / d v_m for
    non-spiking neurons (the reference's semi-analytic check)."""
    m, table, st, group = _port_setup(name)
    zero = torch.zeros(st.v_m.shape[0])
    thr = getattr(group, _THRESH[name])

    def step_of(v):
        return m.step(dataclasses.replace(st, v_m=v), table, zero, zero,
                      surrogate=SURROGATE)

    nxt = step_of(st.v_m)
    assert nxt.spike.dtype == torch.float32 and not nxt.spike.any()
    v = st.v_m.clone().requires_grad_(True)
    (ad,) = torch.autograd.grad(step_of(v).spike.sum(), v)
    beta = surrogate.DEFAULT_FS_BETA
    x = nxt.v_m.double() - thr
    grad_fn = beta / (1.0 + beta * x.abs()) ** 2
    dv = _central_fd(lambda v: step_of(v).v_m, st.v_m, eps=0.05).diagonal()
    np.testing.assert_allclose(ad.numpy(), (grad_fn * dv).numpy(),
                               rtol=5e-2, atol=1e-6)
    assert ad.abs().min() > 0


@pytest.mark.parametrize("cond", [False, True])
def test_lif_twin_surrogate_spike(cond):
    """K2's plain twin with ``spike_fn``: every output but the spike is
    bitwise inference mode's, the spike is the bool as float, and its
    gradient w.r.t. ``v`` is :func:`snn.lif_step`'s surrogate gradient
    (the two sum the membrane in different orders: rtol 1e-5)."""
    _, table, st, _ = _port_setup("lif")
    n = st.v_m.shape[0]
    st = dataclasses.replace(st, v_m=st.v_m + 8.0 * (torch.arange(n) % 2))
    inp = (torch.full((n,), 5.0), torch.full((n,), 2.0))
    fn = surrogate.get_surrogate(SURROGATE)

    def twin(v, spike_fn=None):
        return lif_step_kernel_mod.lif_step_plain(
            v, st.syn_ex, st.syn_in, st.ref_count, st.group_id, *inp, table,
            cond=cond, spike_fn=spike_fn)

    ref, out = twin(st.v_m), twin(st.v_m, fn)
    assert ref[-1].any() and not ref[-1].all()
    for a, b in zip(ref[:-1], out[:-1]):
        assert torch.equal(a, b)
    assert out[-1].dtype == torch.float32
    assert torch.equal(out[-1], ref[-1].to(torch.float32))
    v = st.v_m.clone().requires_grad_(True)
    (ad,) = torch.autograd.grad(twin(v, fn)[-1].sum(), v)
    v2 = st.v_m.clone().requires_grad_(True)
    syn = (snn.SynapseModel.COND_EXP if cond
           else snn.SynapseModel.CURRENT_EXP)
    plain = snn.lif_step(dataclasses.replace(st, v_m=v2), table, *inp,
                         synapse_model=syn, spike_fn=fn)
    (want,) = torch.autograd.grad(plain.spike.sum(), v2)
    assert ad.abs().max() > 0
    np.testing.assert_allclose(ad.numpy(), want.numpy(), rtol=1e-5)


@pytest.mark.parametrize("name", MODELS)
def test_jacobians_match_reference(name):
    """The port's ``torch.func.jacrev`` of the one-step ``v_m`` and of the
    spike sum w.r.t. ``v_m`` == the reference's ``jax.jacrev`` on the same
    state (rtol 1e-5)."""
    m, table, st, _ = _port_setup(name)
    rm, rtable, rst = _ref_setup(name)
    np.testing.assert_array_equal(table.numpy(), np.asarray(rtable))
    n = st.v_m.shape[0]
    zero, rzero = torch.zeros(n), jnp.zeros((n,), jnp.float32)

    def port(v):
        s = m.step(dataclasses.replace(st, v_m=v), table, zero, zero,
                   surrogate=SURROGATE)
        return s.v_m, s.spike.sum()

    def ref(v):
        s = rm.step(dataclasses.replace(rst, v_m=v), rtable, rzero, rzero,
                    surrogate=SURROGATE)
        return s.v_m, s.spike.sum()

    jv, js = torch.func.jacrev(port)(st.v_m)
    rjv, rjs = jax.jacrev(ref)(rst.v_m)
    np.testing.assert_allclose(jv.numpy(), np.asarray(rjv), rtol=1e-5,
                               atol=1e-12)
    np.testing.assert_allclose(js.numpy(), np.asarray(rjs), rtol=1e-5,
                               atol=1e-12)
    assert js.abs().min() > 0


# --------------------------------------------------------------------------
# surrogate mode's forward
# --------------------------------------------------------------------------

def _model_net(pkg_models, name):
    if name == "lif":
        # eta=4: hot enough that spikes land inside the 120-step window
        return pkg_models.brunel(scale=0.01, eta=4.0)[0]
    return pkg_models.model_demo(name, scale=0.005)[0]


@pytest.mark.parametrize("sweep", ["flat", "cuda"])
@pytest.mark.parametrize("name", MODELS)
def test_surrogate_forward_bit_identical(name, sweep):
    """120 steps: surrogate mode's raster and ``v_m`` == inference mode's,
    bitwise, on both backends (on ``"cuda"`` because surrogate mode takes
    inference's fused route and casts its spike to float)."""
    spec = _model_net(models, name)
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(CPU)
    m = neuron_models.get_model(spec.neuron_model)
    table = m.make_param_table(list(spec.groups), 0.1, device=CPU)
    outs = {}
    for mode in (None, SURROGATE):
        cfg = engine.EngineConfig(dt=0.1, sweep=sweep, surrogate=mode,
                                  neuron_model=spec.neuron_model)
        st = engine.init_state(g, list(spec.groups), 0, sweep=sweep,
                               neuron_model=spec.neuron_model, device=CPU)
        fin, spikes = engine.run(st, g, table, cfg, 120, device=CPU)
        outs[mode] = (spikes, fin.neurons.v_m, fin.generator.get_state())
    (sp0, v0, gen0), (sp1, v1, gen1) = outs[None], outs[SURROGATE]
    assert sp0.sum() > 0, "silent - the pin is vacuous"
    assert sp0.dtype == torch.bool and sp1.dtype == torch.float32
    assert torch.equal(sp0.to(torch.float32), sp1)
    assert torch.equal(v0, v1)
    assert torch.equal(gen0, gen1)
    # the route both modes took: K1's fused epilogue on "cuda"
    backend = engine.backends_mod.get_backend(sweep)
    cur = snn.SynapseModel.CURRENT_EXP
    assert backend.update_route(spec.neuron_model, cur) == (
        f"fused:{name}" if sweep == "cuda" else "composed")


def _ref_state_leaves(st, model):
    out = {"neurons.v_m": st.neurons.v_m, "neurons.syn_ex": st.neurons.syn_ex,
           "neurons.syn_in": st.neurons.syn_in,
           "neurons.ref_count": st.neurons.ref_count,
           "neurons.spike": st.neurons.spike, "ring": st.ring,
           "weights": st.weights, "traces.k_pre": st.traces.k_pre,
           "traces.k_post": st.traces.k_post, "t": st.t,
           "gate_overflow": st.gate_overflow}
    out.update({f"neurons.extra.{k}": v for k, v in st.neurons.extra.items()})
    return {k: np.asarray(v) for k, v in out.items()}


def _reference_noise(key, n_local, n_steps):
    """The reference's diffusion draws: ``engine_step`` splits the state
    key each step and draws ``normal(sub, (n_local,))`` from the second
    half (deterministic models split no further)."""
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (n_local,),
                                                dtype=jnp.float32)))
    return np.stack(out)


def _ref_net(name):
    """The reference's build of ``name``'s network, its 1-shard graph, the
    port's copy of that graph, and both tables."""
    spec = _model_net(ref_models, name)
    gr = ref_builder.build_shards(spec, ref_builder.decompose(spec, 1))[0]
    fields = {f.name: getattr(gr, f.name) for f in dataclasses.fields(gr)}
    g = convert.graph_from_numpy(fields).to(CPU)
    rtable = jnp.asarray(ref_nm.get_model(spec.neuron_model)
                         .make_param_table(list(spec.groups), dt=0.1))
    return spec, gr.device_arrays(), g, rtable


@pytest.mark.parametrize("name", MODELS)
def test_surrogate_raster_matches_reference_flat(name):
    """On ``"flat"``, surrogate mode and the diffusion drive, fed the
    reference's own normal draws: the reference's raster exactly, over 120
    steps; ``v_m`` within 1e-3, the reference's own tolerance for the zoo's
    trajectories (XLA's and torch's CPU kernels may contract or order float
    ops differently, and Izhikevich's quadratic amplifies an ulp)."""
    spec, gd, g, rtable = _ref_net(name)
    cfg_ref = ref_engine.EngineConfig(
        dt=0.1, sweep="flat", surrogate=SURROGATE,
        external_drive_mode="diffusion", neuron_model=spec.neuron_model)
    st_ref = ref_engine.init_state(gd, list(spec.groups), jax.random.key(0),
                                   neuron_model=spec.neuron_model)
    fin_ref, sp_ref = jax.jit(
        lambda s: ref_engine.run(s, gd, rtable, cfg_ref, 120))(st_ref)
    noise = _reference_noise(st_ref.key, gd.n_local, 120)

    st = convert.state_from_numpy(_ref_state_leaves(st_ref, spec.neuron_model),
                                  g, sweep="flat", device=CPU,
                                  neuron_model=spec.neuron_model)
    cfg = engine.EngineConfig(dt=0.1, sweep="flat", surrogate=SURROGATE,
                              external_drive_mode="diffusion",
                              neuron_model=spec.neuron_model)
    fin, sp = engine.run(st, g, torch.from_numpy(np.array(rtable)), cfg, 120,
                         drive_noise=torch.from_numpy(noise), device=CPU)
    sp_ref = np.asarray(sp_ref, np.float32)
    assert sp_ref.sum() > 0, "silent - the pin is vacuous"
    np.testing.assert_array_equal(sp.numpy(), sp_ref)
    np.testing.assert_allclose(fin.neurons.v_m.numpy(),
                               np.asarray(fin_ref.neurons.v_m), atol=1e-3)


# --------------------------------------------------------------------------
# the rollout
# --------------------------------------------------------------------------

def _brunel(sweep="flat"):
    spec, _ = models.brunel(scale=0.01, eta=4.0)
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(CPU)
    table = snn.make_param_table(list(spec.groups), 0.1, device=CPU)
    cfg = engine.EngineConfig(dt=0.1, sweep=sweep, surrogate=SURROGATE,
                              external_drive_mode="diffusion")
    return spec, g, table, cfg


def test_checkpointed_rollout_matches_naive():
    """100 steps, ``checkpoint_every=25``: the spikes bitwise, the loss
    exactly, the weight gradients to rtol 1e-5 (the reference's bar) and
    non-zero, and the drive generator in the same state afterwards."""
    spec, g, table, cfg = _brunel()
    out = {}
    for ck in (None, 25):
        st = engine.init_state(g, list(spec.groups), 0, device=CPU)
        w = st.weights.clone().requires_grad_(True)
        fin, spikes = rollout.rollout(dataclasses.replace(st, weights=w), g,
                                      table, cfg, 100, checkpoint_every=ck,
                                      device=CPU)
        loss = spikes.mean()
        (grad,) = torch.autograd.grad(loss, w)
        out[ck] = (spikes.detach(), float(loss.detach()), grad,
                   fin.generator.get_state())
    (s0, l0, g0, gen0), (s1, l1, g1, gen1) = out[None], out[25]
    assert s0.sum() > 0
    assert torch.equal(s0, s1)
    assert l0 == l1
    np.testing.assert_allclose(g0.numpy(), g1.numpy(), rtol=1e-5, atol=1e-8)
    assert g0.abs().max() > 0
    assert torch.equal(gen0, gen1)
    # the generator advanced by exactly the 100 steps' draws
    st = engine.init_state(g, list(spec.groups), 0, device=CPU)
    for _ in range(100):
        torch.randn((g.n_local,), generator=st.generator)
    assert torch.equal(st.generator.get_state(), gen0)


def test_rollout_gradient_matches_reference():
    """d mean(spikes) / d weights over 100 steps on ``"flat"``, the
    reference's diffusion draws injected, against the reference's
    ``jax.grad`` of its rollout: the same raster, gradients within
    rtol 1e-4 + atol 1e-9 (both packages sum the gradient's scatters in
    their own order)."""
    spec = _model_net(ref_models, "lif")
    gr = ref_builder.build_shards(spec, ref_builder.decompose(spec, 1))[0]
    gd = gr.device_arrays()
    rtable = ref_snn.make_param_table(list(spec.groups), dt=0.1)
    cfg_ref = ref_engine.EngineConfig(dt=0.1, surrogate=SURROGATE,
                                      external_drive_mode="diffusion")
    st_ref = ref_engine.init_state(gd, list(spec.groups), jax.random.key(0))

    def ref_loss(w):
        s = dataclasses.replace(st_ref, weights=w)
        _, sp = ref_rollout.rollout(s, gd, rtable, cfg_ref, 100)
        return jnp.mean(sp), sp

    (_, sp_ref), g_ref = jax.value_and_grad(ref_loss, has_aux=True)(
        st_ref.weights)
    noise = torch.from_numpy(_reference_noise(st_ref.key, gd.n_local, 100))

    fields = {f.name: getattr(gr, f.name) for f in dataclasses.fields(gr)}
    g = convert.graph_from_numpy(fields).to(CPU)
    st = convert.state_from_numpy(_ref_state_leaves(st_ref, "lif"), g,
                                  sweep="flat", device=CPU)
    cfg = engine.EngineConfig(dt=0.1, sweep="flat", surrogate=SURROGATE,
                              external_drive_mode="diffusion")
    w = st.weights.clone().requires_grad_(True)
    _, sp = rollout.rollout(dataclasses.replace(st, weights=w), g,
                            torch.from_numpy(np.array(rtable)), cfg, 100,
                            checkpoint_every=25, drive_noise=noise,
                            device=CPU)
    (grad,) = torch.autograd.grad(sp.mean(), w)
    sp_ref = np.asarray(sp_ref, np.float32)
    assert sp_ref.sum() > 0
    np.testing.assert_array_equal(sp.detach().numpy(), sp_ref)
    g_ref = np.asarray(g_ref)
    assert np.abs(g_ref).max() > 0
    np.testing.assert_allclose(grad.numpy(), g_ref, rtol=1e-4, atol=1e-9)


def test_rollout_rejects_bad_chunk_and_inputs():
    spec, g, table, cfg = _brunel()
    st = engine.init_state(g, list(spec.groups), 0, device=CPU)
    with pytest.raises(ValueError, match="multiple of"):
        rollout.rollout(st, g, table, cfg, 100, checkpoint_every=33,
                        device=CPU)
    with pytest.raises(ValueError, match="drive_noise must be"):
        rollout.rollout(st, g, table, cfg, 10,
                        drive_noise=torch.zeros(9, g.n_local), device=CPU)
    with pytest.raises(ValueError, match="external_drive_mode"):
        rollout.rollout(st, g, table, dataclasses.replace(
            cfg, external_drive_mode="gaussian"), 10, device=CPU)
    with pytest.raises(ValueError, match="not both"):
        engine.run(st, g, table, cfg, 2, drive=torch.zeros(2, g.n_local),
                   drive_noise=torch.zeros(2, g.n_local), device=CPU)
    assert rollout.grad_peak_memory_bytes(lambda w: w.sum(),
                                          st.weights) == -1


def test_rollout_keeps_the_native_layout_and_the_determinism_flag():
    """On ``"cuda"`` (its twins here) the final state comes back in the
    blocked layout as carried, the surrogate spikes equal ``engine.run``'s
    (drive noise injected), and the deterministic-algorithms flag is the
    caller's again afterwards."""
    spec, g, table, cfg = _brunel("cuda")
    noise = torch.randn(60, g.n_local,
                        generator=torch.Generator().manual_seed(1))
    st = engine.init_state(g, list(spec.groups), 0, device=CPU)
    assert not torch.are_deterministic_algorithms_enabled()
    with torch.no_grad():
        fin, sp = rollout.rollout(st, g, table, cfg, 60, checkpoint_every=20,
                                  drive_noise=noise, device=CPU)
    assert not torch.are_deterministic_algorithms_enabled()
    assert fin.weights_layout.startswith("blocked:")
    _, want = engine.run(st, g, table, cfg, 60, drive_noise=noise,
                         device=CPU)
    assert want.sum() > 0 and torch.equal(sp, want)
    st2 = engine.normalize_spike_dtype(st, cfg)
    assert st2.neurons.spike.dtype == torch.float32
    assert engine.normalize_spike_dtype(
        st2, dataclasses.replace(cfg, surrogate=None)
    ).neurons.spike.dtype == torch.bool


# --------------------------------------------------------------------------
# the grad guard
# --------------------------------------------------------------------------

def test_gradient_through_cuda_raises_and_no_grad_runs():
    """A loss through ``"cuda"`` with weights that require grad raises the
    guard's error (the kernels would cut the gradient); under
    ``torch.no_grad()`` the same rollout runs, and on ``"flat"`` the
    gradient flows."""
    spec, g, table, cfg = _brunel("cuda")
    st = engine.init_state(g, list(spec.groups), 0, sweep="cuda",
                           device=CPU)
    w = st.weights.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match='sweep=\\"flat\\"|sweep="flat"'):
        rollout.rollout(dataclasses.replace(st, weights=w), g, table, cfg,
                        20, device=CPU)
    with torch.no_grad():
        _, sp = rollout.rollout(dataclasses.replace(st, weights=w), g, table,
                                cfg, 20, device=CPU)
    assert sp.shape == (20, g.n_local)
    # inference mode through "cuda" (the fused route) refuses it too
    infer = dataclasses.replace(cfg, surrogate=None)
    with pytest.raises(RuntimeError, match="requires grad"):
        engine.engine_step(dataclasses.replace(st, weights=w), g, table,
                           infer)


def _guard_cases():
    """Each guarded wrapper on tiny valid CPU inputs, with ``w`` (the
    float input that may require grad) in its weight slot."""
    nb, eb, pb, d, m = 1, 4, 2, 2, 3
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32).reshape(nb, eb)
    pre, post, delay, ch = i32(0, 1, 2, 0), i32(0, 0, 1, 1), \
        i32(1, 2, 1, 0), i32(0, 1, 0, 0)
    ring, t = torch.ones(d, m), torch.tensor(3, dtype=torch.int32)
    n = 2
    lif_state = (torch.full((n,), -60.0), torch.zeros(n), torch.zeros(n),
                 torch.zeros(n, dtype=torch.int32))
    table = snn.make_param_table([snn.LIFParams()], 0.1, device=CPU)
    gid = torch.zeros(n, dtype=torch.int32)
    plastic = torch.ones(nb * eb, dtype=torch.bool)
    params = (0.1, 1.0, 0.4, 1.0, 0.0, 100.0)
    wl, na = torch.zeros(1, dtype=torch.int32), torch.tensor(
        1, dtype=torch.int32)
    return {
        "synaptic_gather": lambda w: gather_kernels.synaptic_gather(
            pre, post, w.reshape(nb, eb), delay, ch, ring, t, max_delay=d,
            pb=pb),
        "synaptic_gather_update": lambda w:
            gather_kernels.synaptic_gather_update(
                pre, post, w.reshape(nb, eb), delay, ch, ring, t, lif_state,
                gid, table, neuron="lif", max_delay=d, pb=pb),
        "blocked_reduce_sweep": lambda w: gather_kernels.blocked_reduce_sweep(
            post, delay, w.reshape(nb, eb), torch.ones(nb, eb), ch,
            max_delay=d, pb=pb),
        "stdp_update": lambda w: stdp_kernels.stdp_update(
            w, pre.reshape(-1), post.reshape(-1), plastic,
            torch.ones(nb * eb), torch.ones(n), torch.ones(m),
            torch.ones(n), params=params, eb=eb, pb=pb),
        "stdp_update_worklist": lambda w: stdp_kernels.stdp_update_worklist(
            w, pre.reshape(-1), post.reshape(-1), plastic,
            torch.ones(nb * eb), wl, na, torch.ones(n), torch.ones(m),
            torch.ones(n), params=params, eb=eb, pb=pb),
        "flash_attention": lambda w: fa_kernels.flash_attention(
            w.reshape(1, 1, 1, 4), torch.ones(1, 2, 1, 4),
            torch.ones(1, 2, 1, 4), causal=False),
    }


@pytest.mark.parametrize("kernel", sorted(_guard_cases()))
def test_kernel_wrapper_refuses_inputs_that_require_grad(kernel):
    """K1, K1 with its epilogue, K3, K6, K7 and K8 (its query in the
    weight slot): the guard raises on the twin's route as on the card's,
    before any launch, and lets the same call through under
    ``torch.no_grad()`` or without grad."""
    call = _guard_cases()[kernel]
    w = torch.full((4,), 2.0)
    call(w.clone())
    with pytest.raises(RuntimeError, match=f"{kernel}: an input requires "
                                           "grad"):
        call(w.clone().requires_grad_(True))
    with torch.no_grad():
        call(w.clone().requires_grad_(True))


def _i_e_800(pkg_models):
    """hpc_benchmark(0.02) with pl-STDP and the constant drive i_e = 800
    pA: the distributed tests' EQUIV spec, firing with the drive off."""
    spec, stdp = pkg_models.hpc_benchmark(scale=0.02, stdp=True)
    return dataclasses.replace(spec, groups=[dataclasses.replace(
        spec.groups[0], i_e=800.0)]), stdp


N_DIST_SURROGATE = 120


@pytest.fixture(scope="module")
def dist_surrogate_reference():
    """The reference single-shard engine's surrogate raster of
    :func:`_i_e_800` (flat, drive off, key 0)."""
    spec, stdp = _i_e_800(ref_models)
    gd = ref_builder.build_shards(spec, ref_builder.decompose(spec, 1))[0] \
        .device_arrays()
    rtable = ref_snn.make_param_table(list(spec.groups), dt=0.1)
    cfg = ref_engine.EngineConfig(dt=0.1, stdp=stdp, external_drive=False,
                                  surrogate=SURROGATE)
    st = ref_engine.init_state(gd, list(spec.groups), jax.random.key(0))
    _, sp = jax.jit(lambda s: ref_engine.run(s, gd, rtable, cfg,
                                             N_DIST_SURROGATE))(st)
    return np.asarray(sp)[:, :spec.n_neurons]


def _dist_net(grid=(2, 2)):
    from repro_torch.core import distributed as dist
    spec, stdp = _i_e_800(models)
    net = dist.prepare_stacked(spec, dist.mesh_decompose(spec, *grid),
                               *grid).to(CPU)
    table = snn.make_param_table(list(spec.groups), 0.1, device=CPU)
    return spec, stdp, net, table


def _dist_surrogate_runs(sweep, exchange=None):
    """The 2x2 stacked run in inference and in surrogate mode (overlap,
    area mode, packed wire), through ``exchange`` (a class; the stacked
    exchange by default)."""
    from repro_torch.core import distributed as dist
    spec, stdp, net, table = _dist_net()
    out = {}
    for mode in (None, SURROGATE):
        cfg = dist.DistributedConfig(engine=engine.EngineConfig(
            dt=0.1, stdp=stdp, sweep=sweep, external_drive=False,
            surrogate=mode))
        st = dist.init_stacked_state(net, list(spec.groups), sweep=sweep,
                                     device=CPU)
        step = dist.make_distributed_step(
            net, table, cfg, device=CPU,
            exchange=None if exchange is None else exchange(net, cfg))
        out[mode] = step.run(st, N_DIST_SURROGATE)
    return spec, net, out


@pytest.mark.parametrize("sweep", ["flat", "cuda"])
def test_stacked_surrogate_equals_inference_and_reference(
        sweep, dist_surrogate_reference):
    """Surrogate mode through the stacked step (2x2): the raster (bool),
    every state tensor and the counters bitwise inference mode's, on
    ``"flat"`` and on the ``"cuda"`` twin; the carried ``prev_bits`` float;
    and the global raster the reference single-shard engine's surrogate
    raster."""
    from repro_torch.core import distributed as dist
    spec, net, out = _dist_surrogate_runs(sweep)
    (f0, s0), (f1, s1) = out[None], out[SURROGATE]
    assert s0.dtype == s1.dtype == torch.bool
    assert s0.sum() > 100, "vacuous - nothing spiked"
    assert torch.equal(s0, s1)
    for k in ("v_m", "syn_ex", "syn_in", "ref_count", "ring", "weights",
              "k_pre", "k_post", "prev_bits", "t", "wire_overflow",
              "gate_overflow"):
        assert torch.equal(getattr(f0, k), getattr(f1, k)), k
    assert f1.prev_bits.dtype == torch.float32
    ref = dist_surrogate_reference
    assert ref.sum() > 100
    np.testing.assert_array_equal(
        dist.global_spikes(s1, net, spec.n_neurons).numpy(),
        ref.astype(bool))


def test_stacked_surrogate_keeps_the_float_spike_and_its_gradient():
    """On ``"flat"`` with the f32 wire (the one codec that keeps floats),
    the carried spike is the surrogate's float with its graph: the spikes
    of step 30 differentiate back to the initial membrane through the
    exchange, while the returned raster stays bool."""
    from repro_torch.core import distributed as dist
    spec, stdp, net, table = _dist_net()
    cfg = dist.DistributedConfig(
        engine=engine.EngineConfig(dt=0.1, stdp=None, sweep="flat",
                                   external_drive=False,
                                   surrogate=SURROGATE),
        spike_wire="f32")
    step = dist.make_distributed_step(net, table, cfg, device=CPU)
    st = dist.init_stacked_state(net, list(spec.groups), device=CPU)
    v0 = st.v_m.clone().requires_grad_(True)
    carry = step.carry_from(dataclasses.replace(st, v_m=v0))
    for _ in range(30):
        bits = step.advance(carry)
    assert bits.dtype == torch.bool
    assert carry.prev_bits.dtype == torch.float32
    assert carry.prev_bits.grad_fn is not None
    (grad,) = torch.autograd.grad(carry.prev_bits.sum(), v0)
    assert torch.isfinite(grad).all() and grad.abs().max() > 0


@pytest.mark.parametrize("change", [{"surrogate": SURROGATE},
                                    {"external_drive_mode": "diffusion"}],
                         ids=["surrogate", "diffusion"])
def test_distributed_step_refuses_surrogate_and_diffusion(change):
    """The distributed step refuses the diffusion drive (the reference's
    distributed step has none: it draws Poisson whatever the mode says)
    and runs surrogate mode: the ``surrogate`` case runs the stacked step
    and the multi-host step's :class:`HostExchange` (one process) and
    holds both to inference mode, bitwise."""
    from repro_torch.core import distributed as dist
    spec, _ = models.hpc_benchmark(0.02)
    net = dist.prepare_stacked(spec, dist.mesh_decompose(spec, 2, 1), 2,
                               1).to(CPU)
    table = snn.make_param_table(list(spec.groups), 0.1, device=CPU)
    cfg = dist.DistributedConfig(engine=engine.EngineConfig(**change))
    st = dist.init_stacked_state(net, list(spec.groups), device=CPU)
    if "external_drive_mode" in change:
        msg = "reference's distributed step has no diffusion drive"
        with pytest.raises(NotImplementedError, match=msg):
            dist.make_distributed_step(net, table, cfg, device=CPU)
        with pytest.raises(NotImplementedError, match=msg):
            dist.run(st, net, table, cfg, 1, device=CPU)
        return
    _, _, out = _dist_surrogate_runs("flat", exchange=dist.HostExchange)
    (f0, s0), (f1, s1) = out[None], out[SURROGATE]
    assert s0.sum() > 100
    assert torch.equal(s0, s1)
    assert torch.equal(f0.v_m, f1.v_m) and torch.equal(f0.weights,
                                                       f1.weights)
    fin, spikes = dist.run(st, net, table, cfg, 5, device=CPU)
    assert spikes.dtype == torch.bool
    assert fin.prev_bits.dtype == torch.float32
