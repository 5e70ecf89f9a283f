"""Port kernels on the card: each CUDA kernel against its plain-torch twin.

These cases need a CUDA device and skip without one (the kernels have no
CPU mode).  The file imports no JAX, so it also runs where only the port's
dependencies are installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import backends, builder, engine, models, neuron_models
from repro_torch.core import snn
from repro_torch import configs
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import adex_step as adex_mod
from repro_torch.kernels import izhikevich_step as izh_mod
from repro_torch.kernels import lif_step as lif_mod
from repro_torch.kernels import stdp_update as stdp_mod
from repro_torch.kernels import synaptic_gather as gather_mod
from repro_torch.models import transformer
from repro_torch.models.model import build_model
from repro_torch.serve.engine import BatchServer

pytestmark = pytest.mark.gpu

STDP_PARAMS = (0.1, 0.0513, 0.4, 45.61, 0.0, 200.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def sorted_blocked(rng, nb, eb, pb, m, d_max):
    """Random blocked ELL arrays in the builder's slot order: each block's
    live slots sorted by (delay, post), padding (delay 0) at the tail."""
    pre = np.zeros((nb, eb), np.int32)
    post = np.zeros((nb, eb), np.int32)
    delay = np.zeros((nb, eb), np.int32)
    for b in range(nb):
        live = int(rng.integers(eb // 2, eb + 1))
        d = rng.integers(1, d_max + 1, live)
        p = rng.integers(0, pb, live)
        order = np.lexsort((p, d))
        delay[b, :live], post[b, :live] = d[order], p[order]
        pre[b, :live] = rng.integers(0, m, live)
    w = rng.normal(0, 50, (nb, eb)).astype(np.float32)
    chan = rng.integers(0, 2, (nb, eb)).astype(np.int32)
    return pre, post, w, delay, chan


@pytest.mark.parametrize("t", [0, 3, 1001])
@pytest.mark.parametrize("with_fresh", [False, True])
def test_gather_kernel_matches_plain(cuda, with_fresh, t):
    rng = np.random.default_rng(5 + t)
    pre, post, w, delay, chan = sorted_blocked(rng, 3, 512, 64, 700, 16)
    ring = (rng.uniform(size=(16, 700)) < 0.3).astype(np.float32)
    args = [torch.from_numpy(x).to(cuda)
            for x in (pre, post, w, delay, chan, ring)]
    fresh = (torch.from_numpy((rng.uniform(size=700) < 0.3)
                              .astype(np.float32)).to(cuda)
             if with_fresh else None)
    tt = torch.tensor(t, dtype=torch.int32, device=cuda)
    launches = gather_mod.synaptic_gather.launches
    outs = [gather_mod.synaptic_gather(*args, tt, max_delay=16, pb=64,
                                       fresh=fresh) for _ in range(2)]
    assert gather_mod.synaptic_gather.launches == launches + 2
    plain = gather_mod.synaptic_gather_plain(*args, tt, max_delay=16, pb=64,
                                             fresh=fresh)
    for a, b in zip(*outs):
        assert torch.equal(a, b)  # no atomics: bitwise deterministic
    assert torch.equal(outs[0][2], plain[2])
    for k in (0, 1):  # summation order differs from index_add_'s
        torch.testing.assert_close(outs[0][k], plain[k], rtol=0, atol=1e-3)


def test_gather_kernel_checks_its_arguments(cuda):
    rng = np.random.default_rng(0)
    pre, post, w, delay, chan = sorted_blocked(rng, 1, 128, 32, 50, 4)
    args = [torch.from_numpy(x).to(cuda) for x in (pre, post, w, delay, chan)]
    ring = torch.zeros((4, 50), device=cuda)
    t = torch.tensor(0, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="weight has dtype"):
        gather_mod.synaptic_gather(*args[:2], args[2].double(), *args[3:],
                                   ring, t, max_delay=4, pb=32)
    with pytest.raises(ValueError, match="ring is on"):
        gather_mod.synaptic_gather(*args, ring.cpu(), t, max_delay=4, pb=32)


def _lif_inputs(rng, n, groups, cuda):
    gs = [snn.LIFParams(tau_m=10.0 + 5 * i, t_ref=0.5 + i,
                        tau_syn_ex=0.5 + 0.2 * i) for i in range(groups)]
    f32 = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)
    arrays = [f32(-52, -48), f32(0, 100), f32(-100, 100),
              rng.integers(0, 4, n).astype(np.int32),
              rng.integers(0, groups, n).astype(np.int32),
              f32(0, 500), f32(-50, 0)]
    return ([torch.from_numpy(a).to(cuda) for a in arrays],
            snn.make_param_table(gs, 0.1, device=cuda))


@pytest.mark.parametrize("cond", [False, True])
def test_lif_kernel_matches_plain(cuda, cond):
    args, table = _lif_inputs(np.random.default_rng(3), 1000, 3, cuda)
    out_k = lif_mod.lif_step(*args, table, cond=cond)
    out_p = lif_mod.lif_step_plain(*args, table, cond=cond)
    assert out_k[4].any(), "no spikes - vacuous"
    for k, p in zip(out_k, out_p):
        # the same op order, no FMA contraction on either side: bitwise
        assert torch.equal(k, p)


@pytest.mark.parametrize("pb", [0, 64])
def test_stdp_kernel_matches_plain(cuda, pb):
    rng = np.random.default_rng(9)
    eb, nb, m = 256, 3, 200
    e, nl = eb * nb, nb * 64
    post = rng.integers(0, pb if pb else nl, e).astype(np.int32)
    args = [torch.from_numpy(x).to(cuda) for x in (
        rng.uniform(1, 100, e).astype(np.float32),
        rng.integers(0, m, e).astype(np.int32), post,
        rng.uniform(size=e) < 0.7,
        (rng.uniform(size=e) < 0.3).astype(np.float32),
        (rng.uniform(size=nl) < 0.3).astype(np.float32),
        rng.uniform(0, 3, m).astype(np.float32),
        rng.uniform(0, 3, nl).astype(np.float32))]
    w_k = stdp_mod.stdp_update(*args, params=STDP_PARAMS, eb=eb, pb=pb)
    w_p = stdp_mod.stdp_update_plain(*args, params=STDP_PARAMS, eb=eb,
                                     pb=pb)
    assert not torch.equal(w_k, args[0]), "no update - vacuous"
    # expf/logf against torch's exp/log kernels: a few ulps
    torch.testing.assert_close(w_k, w_p, rtol=2e-6, atol=0)


def _launches():
    """Every SNN kernel's launch count, the fused kernel's by epilogue."""
    fns = (gather_mod.synaptic_gather, lif_mod.lif_step,
           stdp_mod.stdp_update, izh_mod.izhikevich_step, adex_mod.adex_step,
           gather_mod.blocked_reduce_sweep, stdp_mod.stdp_update_worklist)
    by = gather_mod.synaptic_gather_update.launches_by_neuron
    return {**{f.__name__: f.launches for f in fns},
            **{f"synaptic_gather_{k}": v for k, v in by.items()}}


def _launched(before: dict) -> dict:
    """The kernels launched since ``before`` (:func:`_launches`), with
    their counts."""
    return {k: v - before[k] for k, v in _launches().items()
            if v != before[k]}


def test_cuda_backend_steps_through_the_kernels(cuda):
    """hpc_benchmark(0.02) on the card: the kernel backend and the flat
    backend give the same spikes over 200 steps of one injected drive; K1
    with its LIF epilogue and K3 launch once per step, and neither the
    plain K1 nor the standalone K2 ever."""
    spec, stdp = models.hpc_benchmark(0.02, stdp=True)
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(cuda)
    table = snn.make_param_table(list(spec.groups), 0.1, device=cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    lam = (g.ext_rate * 1e-4).expand(200, -1)
    drive = g.ext_weight * torch.poisson(lam * 1.5, generator=gen)
    runs = {}
    for sweep in ("cuda", "flat"):
        before = _launches()
        st = engine.init_state(g, list(spec.groups), 0, device=cuda)
        cfg = engine.EngineConfig(dt=0.1, stdp=stdp, sweep=sweep)
        runs[sweep] = engine.run(st, g, table, cfg, 200, drive=drive,
                                 device=cuda)
        want = ({"synaptic_gather_lif": 200, "stdp_update": 200}
                if sweep == "cuda" else {})
        assert _launched(before) == want
    (fc, sc), (ff, sf) = runs["cuda"], runs["flat"]
    assert sf.sum() > 0, "no spikes - vacuous"
    assert torch.equal(sc, sf)
    torch.testing.assert_close(fc.weights, ff.weights, rtol=0, atol=1e-4)


@pytest.mark.parametrize("with_drive", [False, True])
@pytest.mark.parametrize("neuron,cond", [("lif", False), ("lif", True),
                                         ("izhikevich", False),
                                         ("adex", False)])
def test_fused_kernel_matches_composition_and_plain(cuda, neuron, cond,
                                                    with_drive):
    """K1 with the neuron epilogue against K1 -> add -> K2/K4/K5 on the
    card: bitwise (one source for the step, ``neuron_math.cuh``, no
    contraction), and twice for determinism.  Against its plain twin:
    arrivals, spikes and ref_count exact; v (and u, w_ad) as the standalone
    kernel's own twin test holds them (LIF and Izhikevich bitwise, AdEx
    within 8 ulps of the largest magnitude: expf against torch's exp); the
    synaptic state within the sums' 1e-3 (another summation order) and 8
    ulps of its magnitude."""
    rng = np.random.default_rng(31 + cond + 2 * with_drive)
    nb, eb, pb, m, d = 3, 512, 64, 700, 16
    pre, post, w, delay, chan = sorted_blocked(rng, nb, eb, pb, m, d)
    ring = (rng.uniform(size=(d, m)) < 0.3).astype(np.float32)
    edge = [torch.from_numpy(x).to(cuda)
            for x in (pre, post, w, delay, chan, ring)]
    tt = torch.tensor(9, dtype=torch.int32, device=cuda)
    n = nb * pb - 21                     # ragged: padding rows take no step
    if neuron == "lif":
        args, table = _lif_inputs(rng, n, 3, cuda)
        state, gid = tuple(args[:4]), args[4]
        kernel, kw = lif_mod.lif_step, dict(cond=cond)
    else:
        _, x, se, si, rc, gid, _, _, table = _two_variable_inputs(
            neuron, rng, n, cuda)
        # membranes up to v_peak or the exponential's clamp, so that some
        # spike
        lo, hi = (-70, 30) if neuron == "izhikevich" else (-60, -30)
        v = torch.from_numpy(rng.uniform(lo, hi, n).astype(np.float32)
                             ).to(cuda)
        mod = izh_mod if neuron == "izhikevich" else adex_mod
        state, kernel, kw = (v, x, se, si, rc), getattr(
            mod, f"{neuron}_step"), {}
    drive = (torch.from_numpy(rng.uniform(0, 300, n).astype(np.float32))
             .to(cuda) if with_drive else None)
    fkw = dict(neuron=neuron, cond=cond, max_delay=d, pb=pb, drive=drive)

    before = _launches()
    outs = [gather_mod.synaptic_gather_update(*edge, tt, state, gid, table,
                                              **fkw) for _ in range(2)]
    assert _launched(before) == {f"synaptic_gather_{neuron}": 2}
    (arr, out), (arr2, out2) = outs
    assert torch.equal(arr, arr2)
    assert all(torch.equal(a, b) for a, b in zip(out, out2))

    ex, inh, arr_k = gather_mod.synaptic_gather(*edge, tt, max_delay=d,
                                                pb=pb)
    ex = ex[:n] if drive is None else ex[:n] + drive
    comp = kernel(*state, gid, ex, inh[:n], table, **kw)
    assert torch.equal(arr, arr_k)
    assert out[-1].any() and (state[-1] > 0).any(), "vacuous"
    for a, b in zip(out, comp):
        assert torch.equal(a, b)

    arr_p, out_p = gather_mod.synaptic_gather_update_plain(
        *edge, tt, state, gid, table, **fkw)
    assert torch.equal(arr, arr_p)
    names = gather_mod.NEURON_STATE[neuron][0] + ("spike",)
    for name, a, b in zip(names, out, out_p):
        ulps = 8 * 2.0 ** -23 * float(b.abs().max()) if b.is_floating_point() \
            else 0
        if name in ("ref_count", "spike") or (
                neuron == "lif" and name == "v") or (
                neuron == "izhikevich" and name in ("v", "u")):
            assert torch.equal(a, b), name
        elif name in ("syn_ex", "syn_in"):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-3 + ulps)
        else:
            torch.testing.assert_close(a, b, rtol=8 * 2.0 ** -23, atol=ulps)


def test_fused_kernel_checks_its_arguments(cuda):
    rng = np.random.default_rng(1)
    pre, post, w, delay, chan = sorted_blocked(rng, 1, 128, 32, 50, 4)
    edge = [torch.from_numpy(x).to(cuda) for x in (pre, post, w, delay,
                                                   chan)]
    ring = torch.zeros((4, 50), device=cuda)
    t = torch.tensor(0, dtype=torch.int32, device=cuda)
    args, table = _lif_inputs(rng, 32, 2, cuda)
    state, gid = tuple(args[:4]), args[4]
    before = _launches()
    with pytest.raises(TypeError, match="drive has dtype"):
        gather_mod.synaptic_gather_update(
            *edge, ring, t, state, gid, table, neuron="lif", max_delay=4,
            pb=32, drive=torch.zeros(32, dtype=torch.float64, device=cuda))
    big = tuple(torch.cat([x, x]) for x in state)
    with pytest.raises(ValueError, match="bad geometry"):
        gather_mod.synaptic_gather_update(
            *edge, ring, t, big, torch.cat([gid, gid]), table, neuron="lif",
            max_delay=4, pb=32)
    # Izhikevich: its (G, 11) table, not LIF's (G, 12); no conductance form
    v, u, se, si, rc, gid, _, _, izh_table = _two_variable_inputs(
        "izhikevich", rng, 32, cuda)
    izh = (v, u, se, si, rc)
    with pytest.raises(ValueError, match=r"expected \(G, 11\)"):
        gather_mod.synaptic_gather_update(
            *edge, ring, t, izh, gid, table, neuron="izhikevich",
            max_delay=4, pb=32)
    with pytest.raises(ValueError, match="conductance"):
        gather_mod.synaptic_gather_update(
            *edge, ring, t, izh, gid, izh_table, neuron="izhikevich",
            cond=True, max_delay=4, pb=32)
    with pytest.raises(TypeError, match="u has dtype"):
        gather_mod.synaptic_gather_update(
            *edge, ring, t, (v, u.double(), se, si, rc), gid, izh_table,
            neuron="izhikevich", max_delay=4, pb=32)
    assert _launched(before) == {}


def _two_variable_inputs(model, rng, n, cuda):
    """Seeded (v, x, syn_ex, syn_in, ref_count, group_id, input_ex,
    input_in, table) for K4 or K5, over 3 groups."""
    m = neuron_models.get_model(model)
    if model == "izhikevich":
        gs = [neuron_models.IzhikevichParams(a=0.02 + 0.04 * i, d=8.0 - 3 * i,
                                             t_ref=0.3 * i)
              for i in range(3)]
        lo_hi = ((-70, 25), (-16, 0), (0, 30), (-30, 0), (0, 20), (-20, 0))
    else:
        gs = [neuron_models.AdExParams(i_e=400.0 * i, t_ref=2.0 - 0.7 * i)
              for i in range(3)]
        lo_hi = ((-75, -35), (0, 100), (0, 300), (-300, 0), (0, 50),
                 (-50, 0))
    f32 = [torch.from_numpy(rng.uniform(lo, hi, n).astype(np.float32))
           .to(cuda) for lo, hi in lo_hi]
    ints = [torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)).to(cuda)
            for _ in range(2)]
    return (*f32[:4], *ints, *f32[4:],
            m.make_param_table(gs, 0.1, device=cuda))


@pytest.mark.parametrize("n", [1000, 10000])
@pytest.mark.parametrize("model", ["izhikevich", "adex"])
def test_two_variable_kernels_match_plain(cuda, model, n):
    """K4 equals its twin bitwise (the same op order, no contraction, no
    transcendental).  K5's expf and torch's exp kernel may differ by ulps,
    so its floats are held within 8 ulps of their largest magnitude;
    spikes and ref_count are exact for both."""
    mod = izh_mod if model == "izhikevich" else adex_mod
    kernel = getattr(mod, f"{model}_step")
    plain = getattr(mod, f"{model}_step_plain")
    args = _two_variable_inputs(model, np.random.default_rng(n), n, cuda)
    launches = kernel.launches
    out_k = [kernel(*args) for _ in range(2)]
    assert kernel.launches == launches + 2
    out_p = plain(*args)
    assert out_k[0][5].any() and (args[4] > 0).any(), "vacuous"
    for a, b in zip(*out_k):
        assert torch.equal(a, b)          # deterministic
    for i, (k, p) in enumerate(zip(out_k[0], out_p)):
        if model == "izhikevich" or i >= 4:
            assert torch.equal(k, p), i
        else:
            tol = 8 * 2.0 ** -23 * float(p.abs().max())
            torch.testing.assert_close(k, p, rtol=8 * 2.0 ** -23, atol=tol)


@pytest.mark.parametrize("model", ["lif", "izhikevich", "adex"])
def test_kernels_read_a_composite_table_in_place(cuda, model):
    """``<model>+poisson`` hands the base kernel ``table[:, :-1]``, whose
    rows lie one column further apart: the kernel reads it in place and
    returns what it returns for a contiguous copy."""
    rng = np.random.default_rng(5)
    if model == "lif":
        args, table = _lif_inputs(rng, 1000, 3, cuda)
        kernel = lif_mod.lif_step
    else:
        *args, table = _two_variable_inputs(model, rng, 1000, cuda)
        kernel = getattr(izh_mod if model == "izhikevich" else adex_mod,
                         f"{model}_step")
    wide = torch.cat([table, torch.rand(table.shape[0], 1, device=cuda)], 1)
    view = wide[:, :-1]
    assert not view.is_contiguous()
    for a, b in zip(kernel(*args, view), kernel(*args, table)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("model", ["izhikevich", "adex"])
def test_cuda_backend_steps_the_zoo_through_the_kernels(cuda, model):
    """model_demo(model, 0.02, stdp=True) on the card, 200 steps: the
    kernel and flat backends give the same spikes.  Each launches K1 with
    its model's epilogue and K3 once per step, and neither the plain K1
    nor the standalone K4/K5."""
    spec, stdp = models.model_demo(model, 0.02, stdp=True)
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(cuda)
    table = neuron_models.get_model(model).make_param_table(
        list(spec.groups), 0.1, device=cuda)
    runs = {}
    for sweep in ("cuda", "flat"):
        before = _launches()
        st = engine.init_state(g, list(spec.groups), 0, neuron_model=model,
                               device=cuda)
        cfg = engine.EngineConfig(dt=0.1, stdp=stdp, sweep=sweep,
                                  neuron_model=model)
        runs[sweep] = engine.run(st, g, table, cfg, 200, device=cuda)
        want = {f"synaptic_gather_{model}": 200, "stdp_update": 200}
        assert _launched(before) == (want if sweep == "cuda" else {})
    (fc, sc), (ff, sf) = runs["cuda"], runs["flat"]
    assert sf.sum() > 0, "no spikes - vacuous"
    assert torch.equal(sc, sf)
    torch.testing.assert_close(fc.weights, ff.weights, rtol=0, atol=1e-4)


@pytest.mark.parametrize("scenario", ["hpc_benchmark", "brunel"])
def test_a_step_never_waits_for_the_card(cuda, scenario):
    """``engine_step`` issues no host synchronisation (the engine's
    contract): under ``torch.cuda.set_sync_debug_mode("error")`` every
    synchronising call raises.  hpc_benchmark covers STDP, the drive and
    K1's LIF epilogue, brunel with Poisson emitters the composite model,
    its draws and the standalone K2 after K1."""
    spec, stdp = models.get_scenario(scenario, scale=0.02,
                                     **({"stdp": True}
                                        if scenario == "hpc_benchmark"
                                        else {"poisson_input": True}))
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(cuda)
    table = neuron_models.get_model(spec.neuron_model).make_param_table(
        list(spec.groups), 0.1, device=cuda)
    cfg = engine.EngineConfig(dt=0.1, stdp=stdp,
                              neuron_model=spec.neuron_model)
    st = engine.init_state(g, list(spec.groups), 0, sweep="cuda",
                           neuron_model=spec.neuron_model, device=cuda)
    st, _ = engine.engine_step(st, g, table, cfg)   # builds the layout
    torch.cuda.synchronize()
    before = _launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(5):
            st, _ = engine.engine_step(st, g, table, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(st.t) == 6
    assert _launched(before) == (
        {"synaptic_gather_lif": 5, "stdp_update": 5}
        if scenario == "hpc_benchmark"
        else {"synaptic_gather": 5, "lif_step": 5})


# --------------------------------------------------------------------------
# the activity gate: K6 and K7
# --------------------------------------------------------------------------

GATE_LISTS = {  # name -> (listed blocks of 6, capacity, n_active)
    "no_list": (None, 0, 0),
    "partial": ([1, 4], 3, 2),
    "empty": ([], 3, 0),
    "identity": (list(range(6)), 6, 6),
    "saturated": ([0, 2, 3], 3, 5),
}


def _gate_list(case, nb, cuda):
    blocks, cap, n_act = GATE_LISTS[case]
    if blocks is None:
        return None, None
    wl = np.full(cap, nb, np.int32)
    wl[:len(blocks)] = blocks
    return (torch.from_numpy(wl).to(cuda),
            torch.tensor(n_act, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("case", sorted(GATE_LISTS))
def test_reduce_kernel_matches_plain_and_k1(cuda, case):
    """K6 against its twin (another summation order) and, on the walked
    blocks, against K1's sums on the same arrivals bitwise; unlisted rows
    are zero; two launches agree bitwise."""
    rng = np.random.default_rng(21)
    nb, eb, pb, m, d = 6, 512, 64, 700, 16
    pre, post, w, delay, chan = sorted_blocked(rng, nb, eb, pb, m, d)
    ring = (rng.uniform(size=(d, m)) < 0.3).astype(np.float32)
    args = [torch.from_numpy(x).to(cuda)
            for x in (pre, post, w, delay, chan, ring)]
    tt = torch.tensor(9, dtype=torch.int32, device=cuda)
    ex1, in1, arrived = gather_mod.synaptic_gather(*args, tt, max_delay=d,
                                                   pb=pb)
    wl, na = _gate_list(case, nb, cuda)
    post_t, w_t, delay_t, chan_t = args[1], args[2], args[3], args[4]
    launches = gather_mod.blocked_reduce_sweep.launches
    outs = [gather_mod.blocked_reduce_sweep(
        post_t, delay_t, w_t, arrived, chan_t, max_delay=d, pb=pb,
        worklist=wl, n_active=na) for _ in range(2)]
    assert gather_mod.blocked_reduce_sweep.launches == launches + 2
    plain = gather_mod.blocked_reduce_sweep_plain(
        post_t, w_t, arrived, chan_t, pb=pb, worklist=wl, n_active=na)
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    for k in (0, 1):
        torch.testing.assert_close(outs[0][k], plain[k], rtol=0, atol=1e-3)
    listed = (torch.ones(nb, dtype=torch.bool, device=cuda) if wl is None
              else gather_mod.listed_blocks(wl, na, nb))
    rows = listed.repeat_interleave(pb)
    assert torch.equal(outs[0][0][rows], ex1[rows])
    assert torch.equal(outs[0][1][rows], in1[rows])
    assert not outs[0][0][~rows].any() and not outs[0][1][~rows].any()


@pytest.mark.parametrize("case", sorted(set(GATE_LISTS) - {"no_list"}))
def test_stdp_worklist_kernel_matches_plain_and_k3(cuda, case):
    """K7 in place against its twin and, on the walked blocks, against K3
    bitwise; the other blocks' weights are untouched."""
    rng = np.random.default_rng(23)
    nb, eb, pb, m = 6, 256, 64, 200
    e, nl = nb * eb, nb * pb - pb // 2
    post = rng.integers(0, pb, e).astype(np.int32)
    post[-eb:] %= pb // 2
    w0 = torch.from_numpy(rng.uniform(1, 100, e).astype(np.float32)).to(cuda)
    args = [torch.from_numpy(x).to(cuda) for x in (
        rng.integers(0, m, e).astype(np.int32), post,
        rng.uniform(size=e) < 0.7,
        (rng.uniform(size=e) < 0.3).astype(np.float32))]
    rest = [torch.from_numpy(x).to(cuda) for x in (
        (rng.uniform(size=nl) < 0.3).astype(np.float32),
        rng.uniform(0, 3, m).astype(np.float32),
        rng.uniform(0, 3, nl).astype(np.float32))]
    wl, na = _gate_list(case, nb, cuda)
    kw = dict(params=STDP_PARAMS, eb=eb, pb=pb)
    launches = stdp_mod.stdp_update_worklist.launches
    outs = []
    for _ in range(2):
        w = w0.clone()
        assert stdp_mod.stdp_update_worklist(w, *args, wl, na, *rest,
                                             **kw) is w
        outs.append(w)
    assert stdp_mod.stdp_update_worklist.launches == launches + 2
    assert torch.equal(outs[0], outs[1])
    wp = stdp_mod.stdp_update_worklist_plain(w0.clone(), *args, wl, na,
                                             *rest, **kw)
    torch.testing.assert_close(outs[0], wp, rtol=2e-6, atol=0)
    w3 = stdp_mod.stdp_update(w0, *args, *rest, **kw)
    slots = gather_mod.listed_blocks(wl, na, nb).repeat_interleave(eb)
    assert torch.equal(outs[0][slots], w3[slots])
    assert torch.equal(outs[0][~slots], w0[~slots])
    assert case == "empty" or not torch.equal(outs[0], w0), "vacuous"


def _gated_net(cuda, scale=0.2):
    spec, stdp = models.hpc_benchmark(scale, stdp=True)
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(cuda)
    table = snn.make_param_table(list(spec.groups), 0.1, device=cuda)
    return spec, stdp, g, table


def test_gated_backend_steps_through_its_kernels(cuda):
    """hpc_benchmark(0.2) (NB 9): ``cuda:sparse:1e-7`` (capacity 8) gives
    the ``cuda`` backend's spikes, voltages and weights bitwise over 300
    steps of one injected drive; K6, K2 and K7 launch once per step (the
    gate keeps the standalone K2), K1 and K3 never; the gate saturated on
    some steps and not on others."""
    spec, stdp, g, table = _gated_net(cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    lam = (g.ext_rate * 1e-4).expand(300, -1)
    drive = g.ext_weight * torch.poisson(lam * 1.5, generator=gen)
    runs = {}
    for sweep, want in (
            ("cuda", {"synaptic_gather_lif": 300, "stdp_update": 300}),
            ("cuda:sparse:1e-7", {"blocked_reduce_sweep": 300,
                                  "lif_step": 300,
                                  "stdp_update_worklist": 300})):
        assert sweep == "cuda" or backends.get_backend(sweep).gate_capacity(
            backends.get_backend(sweep).prepare(g)) == 8 < g.blocked.nb
        before = _launches()
        st = engine.init_state(g, list(spec.groups), 0, device=cuda)
        cfg = engine.EngineConfig(dt=0.1, stdp=stdp, sweep=sweep)
        runs[sweep] = engine.run(st, g, table, cfg, 300, drive=drive,
                                 device=cuda)
        assert _launched(before) == want
    (fd, sd), (fg, sg) = runs["cuda"], runs["cuda:sparse:1e-7"]
    assert sd.sum() > 0, "no spikes - vacuous"
    assert torch.equal(sd, sg)
    assert torch.equal(fd.neurons.v_m, fg.neurons.v_m)
    assert torch.equal(fd.weights, fg.weights)
    assert 0 < int(fg.gate_overflow) < 300, "one branch never ran"
    assert int(fd.gate_overflow) == 0


def test_a_gated_step_never_waits_for_the_card(cuda):
    """Five ``cuda:sparse:1e-7`` steps (capacity 8 of 9 blocks: the
    worklist, K6 and K7 with the branch decided on the device) under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    spec, stdp, g, table = _gated_net(cuda)
    cfg = engine.EngineConfig(dt=0.1, stdp=stdp, sweep="cuda:sparse:1e-7")
    st = engine.init_state(g, list(spec.groups), 0, sweep=cfg.sweep,
                           device=cuda)
    st, _ = engine.engine_step(st, g, table, cfg)   # builds the layout
    torch.cuda.synchronize()
    launches = stdp_mod.stdp_update_worklist.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(5):
            st, _ = engine.engine_step(st, g, table, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert stdp_mod.stdp_update_worklist.launches == launches + 5
    assert int(st.t) == 6


# --------------------------------------------------------------------------
# K8: flash attention, and the LM serving path through it
# --------------------------------------------------------------------------

FLASH_CASES = {
    # tests/test_flash_attention.py's cases (fp32)
    "gqa_ragged": (2, 300, 300, 8, 2, 32, 32, True, torch.float32),
    "mha": (1, 128, 128, 4, 4, 16, 16, True, torch.float32),
    "cross": (2, 100, 150, 4, 4, 16, 16, False, torch.float32),
    "dv_ne_dh": (1, 257, 257, 2, 1, 64, 32, True, torch.float32),
    "bf16": (1, 64, 64, 2, 2, 16, 16, True, torch.bfloat16),
    # qwen2.5-3b's head layout, short sequence, both dtypes
    "qwen_heads": (2, 200, 200, 16, 2, 128, 128, True, torch.bfloat16),
    "qwen_heads_f32": (1, 130, 130, 16, 2, 128, 128, True, torch.float32),
    "dh_256": (1, 70, 70, 2, 1, 256, 256, True, torch.float32),
    # the tensor-core route: qwen2.5-3b's heads at a ragged length,
    # internvl2-1b's LLM heads, cross attention, dv < dh, no grouping, a
    # long causal prefill through the ring, the widest heads
    "qwen_heads_ragged": (2, 300, 300, 16, 2, 128, 128, True,
                          torch.bfloat16),
    "internvl2-1b_heads": (2, 333, 333, 14, 2, 64, 64, True,
                           torch.bfloat16),
    "cross_bf16": (2, 100, 150, 4, 4, 64, 64, False, torch.bfloat16),
    "dv_lt_dh_bf16": (1, 257, 257, 2, 1, 64, 32, True, torch.bfloat16),
    "mha_bf16": (1, 200, 200, 8, 8, 128, 128, True, torch.bfloat16),
    "long_causal": (1, 4096, 4096, 16, 2, 128, 128, True, torch.bfloat16),
    "dh_256_bf16": (1, 70, 70, 2, 1, 256, 256, True, torch.bfloat16),
}
#: the route each dtype's cases take (``flash_attention._route``)
FLASH_ROUTE = {torch.bfloat16: "wgmma", torch.float32: "simt"}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernel_matches_plain(cuda, case):
    b, s, t, h, hk, dh, dv, causal, dtype = FLASH_CASES[case]
    rng = np.random.default_rng(s + t)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda, dtype) for shape in
        ((b, s, h, dh), (b, t, hk, dh), (b, t, hk, dv)))
    route = FLASH_ROUTE[dtype]
    assert fa_mod._route(q, k, v) == route
    launches = fa_mod.flash_attention.launches
    by_route = dict(fa_mod.flash_attention.launches_by_route)
    outs = [fa_mod.flash_attention(q, k, v, causal=causal) for _ in range(2)]
    assert fa_mod.flash_attention.launches == launches + 2
    by_route[route] += 2
    assert fa_mod.flash_attention.launches_by_route == by_route
    plain = fa_mod.flash_attention_plain(q, k, v, causal=causal)
    assert outs[0].shape == (b, s, h * dv) and outs[0].dtype == dtype
    assert torch.equal(outs[0], outs[1])   # no atomics: deterministic
    # fp32: another summation order; bf16: one rounding of the output
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-5))
    torch.testing.assert_close(outs[0].float(), plain.float(), **tol)


def test_flash_kernel_reads_strided_views(cuda):
    """The tensor-core route reads q, k and v through their strides: a
    (B, H, S, dh) layout seen as (B, S, H, dh), and the same call on
    contiguous copies, give the same bits; a view TMA cannot take goes to
    the SIMT route."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda, torch.bfloat16).transpose(1, 2)
        for shape in ((2, 8, 130, 64), (2, 2, 130, 64), (2, 2, 130, 64)))
    assert fa_mod._route(q, k, v) == "wgmma"
    got = fa_mod.flash_attention(q, k, v)
    want = fa_mod.flash_attention(*(x.contiguous() for x in (q, k, v)))
    assert torch.equal(got, want)
    wide = torch.zeros(2, 130, 2, 65, device=cuda, dtype=torch.bfloat16)
    k_odd = wide[..., 1:]                  # 2 bytes off 16
    k_odd.copy_(k)
    assert fa_mod._route(q, k_odd, v) == "simt"
    plain = fa_mod.flash_attention_plain(q, k, v).float()
    for out in (got, fa_mod.flash_attention(q, k_odd, v)):
        torch.testing.assert_close(out.float(), plain, rtol=2 ** -7,
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_takes_broadcast_views(cuda, dtype):
    """k and v broadcast over the batch (stride 0) and q broadcast over
    its heads: each route reads them through those strides and agrees
    with the twin."""
    rng = np.random.default_rng(2)
    q1, k1, v1 = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda, dtype)
        for shape in ((3, 90, 1, 64), (1, 90, 2, 64), (1, 90, 2, 64)))
    q = q1.expand(3, 90, 4, 64)
    k, v = k1.expand(3, 90, 2, 64), v1.expand(3, 90, 2, 64)
    route = fa_mod._route(q, k, v)
    assert route == FLASH_ROUTE[dtype]
    out = fa_mod.flash_attention(q, k, v)
    plain = fa_mod.flash_attention_plain(q, k, v)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-5))
    torch.testing.assert_close(out.float(), plain.float(), **tol)


@pytest.mark.parametrize("case", ["fp16", "head_ratio", "head_dim",
                                  "cpu_k", "strides", "kv_length"])
def test_flash_kernel_checks_its_arguments(cuda, case):
    q = torch.zeros(1, 8, 4, 16, device=cuda)
    k = torch.zeros(1, 8, 2, 16, device=cuda)
    args = {
        "fp16": (q.half(), k.half(), k.half()),
        "head_ratio": (torch.zeros(1, 8, 3, 16, device=cuda), k, k),
        "head_dim": (torch.zeros(1, 8, 4, 512, device=cuda),
                     torch.zeros(1, 8, 2, 512, device=cuda), k),
        "cpu_k": (q, k.cpu(), k),
        "strides": (torch.zeros(1, 8, 16, 4, device=cuda).transpose(2, 3),
                    k, k),
        "kv_length": (q, k, torch.zeros(1, 9, 2, 16, device=cuda)),
    }[case]
    launches = fa_mod.flash_attention.launches
    with pytest.raises((TypeError, ValueError)):
        fa_mod.flash_attention(*args)
    assert fa_mod.flash_attention.launches == launches


def test_lm_serves_through_the_flash_kernel(cuda):
    """qwen2.5-3b's smoke config on the card: K8 once per layer in the
    prefill, never in decode; a second wave gives the same tokens, and
    the prefill logits equal ``forward``'s."""
    cfg = configs.get_smoke("qwen2.5-3b")
    m = build_model(cfg)
    params = m.init(0, device=cuda)
    srv = BatchServer(m, params, slots=4, max_len=64, eos_id=-1,
                      device=cuda)
    reqs = [[5, 6, 7], [8, 9], [3, 4, 5, 6]]
    launches = fa_mod.flash_attention.launches
    by_route = dict(fa_mod.flash_attention.launches_by_route)
    out, stats = srv.serve(reqs, max_new_tokens=8)
    assert fa_mod.flash_attention.launches == launches + cfg.n_layers
    by_route["simt"] += cfg.n_layers       # the smoke config is fp32
    assert fa_mod.flash_attention.launches_by_route == by_route
    assert stats.tokens_out == 24
    assert srv.serve(reqs, max_new_tokens=8)[0] == out
    cache = m.init_cache(4, 64, dtype=torch.float32, device=cuda)
    toks = torch.tensor([[5, 6, 7]] * 4, device=cuda)
    logits, cache = m.prefill(params, {"tokens": toks}, cache)
    launches = fa_mod.flash_attention.launches
    m.decode(params, cache, logits[:, -1].argmax(-1),
             torch.full((4,), 3, device=cuda))
    assert fa_mod.flash_attention.launches == launches
    logits_t = transformer.forward(params, cfg, toks)[0][:, -1]
    torch.testing.assert_close(logits[:, -1], logits_t, rtol=1e-5,
                               atol=1e-5)


def test_an_lm_step_never_waits_for_the_card(cuda):
    """A prefill and two decode steps of qwen2.5-3b's smoke config under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing on the path
    copies from pageable host memory or reads the card (the serve loop's
    one read per step is its own)."""
    cfg = configs.get_smoke("qwen2.5-3b")
    m = build_model(cfg)
    params = m.init(0, device=cuda)
    cache = m.init_cache(2, 32, dtype=torch.float32, device=cuda)
    toks = torch.tensor([[5, 6, 7], [8, 9, 10]], device=cuda)
    pos = torch.full((2,), 3, device=cuda)
    m.decode(params, m.prefill(params, {"tokens": toks}, cache)[1],
             toks[:, 0], pos)                    # warm: caches, handles
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, cache = m.prefill(params, {"tokens": toks}, cache)
        tok = logits[:, -1].argmax(-1)
        for i in range(2):
            logits, cache = m.decode(params, cache, tok, pos + i)
            tok = logits.argmax(-1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(logits).all())
