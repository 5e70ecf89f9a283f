"""The scenario zoo: benchmark networks as NetworkSpec factories.

The port of the reference package's ``core/models.py``; every factory
emits the reference's spec field for field, so the build arrays and
:func:`scenario_id` agree with the reference's
(``tests/test_torch_zoo.py``).

1. :func:`hpc_benchmark` - NEST's "Random balanced network HPC benchmark",
   the paper's verification case (§IV.A): a Brunel-style balanced random
   network with fixed indegree whose E->E synapses use power-law STDP,
   firing asynchronous-irregular below ~10 Hz.
2. :func:`marmoset` - the evaluation case (§IV.B): a multi-area cortical
   network with Potjans-Diesmann-like internals and distance-dependent
   inter-area projections and delays.
3. :func:`brunel` - Brunel (2000)'s sparsely connected E/I network; with
   ``poisson_input=True`` the external drive is an explicit Poisson emitter
   population (the ``"lif+poisson"`` composite model).
4. :func:`microcircuit` - the Potjans-Diesmann (2014) cortical column.
5. :func:`model_demo` - a balanced E/I network for any registered neuron
   model (lif, izhikevich, adex, poisson).

All factories return ``(NetworkSpec, STDPParams | None)`` except
:func:`marmoset` (kept signature-stable, as in the reference);
:func:`get_scenario` normalizes.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

from repro_torch.core.builder import (NetworkSpec, Population, Projection,
                                      spec_to_dict)
from repro_torch.core.decomposition import AreaSpec
from repro_torch.core.neuron_models import (AdExParams, IzhikevichParams,
                                            PoissonParams)
from repro_torch.core.snn import LIFParams
from repro_torch.core.stdp import STDPParams

__all__ = ["hpc_benchmark", "marmoset", "brunel", "microcircuit",
           "model_demo", "get_scenario", "available_scenarios",
           "resolve_scenario", "scenario_id", "HPC_STDP", "DT_MS",
           "firing_rate_hz"]

# dt = 0.1 ms everywhere (NEST default for these models)
DT_MS = 0.1

# STDP parameters of the hpc_benchmark E->E synapses (stdp_pl_synapse_hom).
HPC_STDP = STDPParams(lam=0.1, alpha=0.0513, mu=0.4, w0=45.61,
                      tau_plus=15.0, tau_minus=30.0, w_min=0.0, w_max=200.0)


def _ball(rng: np.random.Generator, n: int, center, radius: float):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-12
    r = radius * rng.uniform(size=(n, 1)) ** (1.0 / 3.0)
    return np.asarray(center, dtype=np.float64) + v * r


def hpc_benchmark(scale: float = 1.0, *, stdp: bool = True,
                  seed: int = 42) -> tuple[NetworkSpec, STDPParams | None]:
    """Balanced random network; scale=1 -> 11250 neurons (NEST convention)."""
    rng = np.random.default_rng(seed)
    n = max(int(round(11250 * scale)), 20)
    ne, ni = int(0.8 * n), n - int(0.8 * n)
    eps = 0.1
    k_e = max(1, min(int(eps * ne), ne - 1))
    k_i = max(1, min(int(eps * ni), ni - 1))

    je = 45.61       # pA (~0.15 mV PSP at these membrane params)
    g = 5.0
    ji = -g * je
    delay_steps = int(round(1.5 / DT_MS))  # 1.5 ms
    max_delay = delay_steps + 1

    lif = LIFParams(tau_m=10.0, c_m=250.0, e_l=-65.0, v_th=-50.0,
                    v_reset=-65.0, t_ref=0.5, tau_syn_ex=0.5, tau_syn_in=0.5)

    # external drive: eta * nu_threshold through the same synapse weight;
    # eta tuned so the network sits in the asynchronous-irregular regime
    # below 10 Hz (the NEST reference band for this benchmark, §IV.A).
    eta = 0.92
    nu_thr_hz = 1e3 * (lif.v_th - lif.e_l) * lif.c_m / (
        je * lif.tau_m * lif.tau_syn_ex)  # rate whose mean drive reaches theta
    ext_rate = eta * nu_thr_hz

    area = AreaSpec(name="net", n_neurons=n,
                    positions=_ball(rng, n, (0, 0, 0), 1.0))
    pops = [
        Population("E", area=0, group=0, n=ne,
                   ext_rate_hz=ext_rate, ext_weight=je),
        Population("I", area=0, group=0, n=ni,
                   ext_rate_hz=ext_rate, ext_weight=je),
    ]
    projections = [
        Projection(0, 0, k_e, je, 0.0, delay_steps, delay_steps,
                   channel=0, plastic=stdp),
        Projection(0, 1, k_e, je, 0.0, delay_steps, delay_steps, channel=0),
        Projection(1, 0, k_i, ji, 0.0, delay_steps, delay_steps, channel=1),
        Projection(1, 1, k_i, ji, 0.0, delay_steps, delay_steps, channel=1),
    ]
    spec = NetworkSpec(areas=[area], groups=[lif], populations=pops,
                       projections=projections, max_delay=max_delay,
                       seed=seed)
    return spec, (HPC_STDP if stdp else None)


def marmoset(scale: float = 1.0, *, n_areas: int = 8,
             seed: int = 7) -> NetworkSpec:
    """Multi-area marmoset-style cortical network.

    scale=1 -> ~1M neurons total across ``n_areas`` areas (paper's
    normalized problem size 1); edges ~ 3.8B at full indegrees.  Tests and
    CPU benchmarks use small scales; indegrees shrink proportionally below
    the biological caps exactly as NEST's hpc_benchmark does.
    """
    rng = np.random.default_rng(seed)
    # area centers on a cortical shell (radius 15 mm), sizes log-normal-ish
    centers = _ball(rng, n_areas, (0, 0, 0), 1.0)
    centers *= 15.0 / (np.linalg.norm(centers, axis=1, keepdims=True) + 1e-9)
    rel = rng.lognormal(mean=0.0, sigma=0.35, size=n_areas)
    rel /= rel.sum()
    n_total = max(int(round(1_000_000 * scale)), 40 * n_areas)
    sizes = np.maximum((rel * n_total).astype(np.int64), 20)

    dist = np.linalg.norm(centers[:, None, :] - centers[None, :, :], axis=-1)
    velocity = 3.5  # mm/ms
    inter_delay_steps = np.maximum(
        np.round(dist / velocity / DT_MS).astype(np.int64), 1)
    max_delay = int(inter_delay_steps.max()) + int(round(2.0 / DT_MS)) + 1

    exc = LIFParams(tau_m=10.0, c_m=250.0, e_l=-65.0, v_th=-50.0,
                    v_reset=-65.0, t_ref=2.0, tau_syn_ex=0.5, tau_syn_in=0.5)
    inh = LIFParams(tau_m=10.0, c_m=250.0, e_l=-65.0, v_th=-50.0,
                    v_reset=-65.0, t_ref=1.0, tau_syn_ex=0.5, tau_syn_in=0.5)

    je, g = 87.8, 4.0  # Potjans-Diesmann reference weight (pA) and balance
    ji = -g * je
    ext_rate = 8.0 * 2300.0  # 2300 ext synapses @ 8 Hz, collapsed rate
    delay_intra_lo = int(round(0.5 / DT_MS))
    delay_intra_hi = int(round(2.0 / DT_MS))

    areas, pops, projections = [], [], []
    lam_mm = 15.0  # exponential distance rule length constant
    for a in range(n_areas):
        n_a = int(sizes[a])
        ne, ni = int(0.8 * n_a), n_a - int(0.8 * n_a)
        areas.append(AreaSpec(
            name=f"area{a}", n_neurons=n_a,
            positions=_ball(rng, n_a, centers[a], 2.0)))
        pe, pi = 2 * a, 2 * a + 1
        # drive tuned to the fluctuation regime (~10-25 Hz population rates,
        # the Potjans-Diesmann operating band)
        pops.append(Population(f"A{a}E", area=a, group=0, n=ne,
                               ext_rate_hz=ext_rate, ext_weight=je * 0.43))
        pops.append(Population(f"A{a}I", area=a, group=1, n=ni,
                               ext_rate_hz=ext_rate * 0.85,
                               ext_weight=je * 0.43))
        # intra-area Potjans-like indegrees (scaled with population size)
        k_ee = max(1, min(int(0.10 * ne), ne - 1))
        k_ei = max(1, min(int(0.10 * ne), ne))
        k_ie = max(1, min(int(0.12 * ni), ni))
        k_ii = max(1, min(int(0.12 * ni), ni - 1))
        projections += [
            Projection(pe, pe, k_ee, je, je * 0.1, delay_intra_lo,
                       delay_intra_hi, channel=0),
            Projection(pe, pi, k_ei, je, je * 0.1, delay_intra_lo,
                       delay_intra_hi, channel=0),
            Projection(pi, pe, k_ie, ji, abs(ji) * 0.1, delay_intra_lo,
                       delay_intra_hi, channel=1),
            Projection(pi, pi, k_ii, ji, abs(ji) * 0.1, delay_intra_lo,
                       delay_intra_hi, channel=1),
        ]

    # inter-area E->E, density decays with distance (exponential rule)
    for a in range(n_areas):
        ne_a = pops[2 * a].n
        for b in range(n_areas):
            if a == b:
                continue
            w_ab = float(np.exp(-dist[a, b] / lam_mm))
            k = int(round(0.02 * ne_a * w_ab))
            if k < 1:
                continue
            d0 = int(inter_delay_steps[a, b])
            projections.append(Projection(
                2 * b, 2 * a, min(k, pops[2 * b].n), je * 0.8, je * 0.08,
                d0, min(d0 + 5, max_delay), channel=0,
                src_frac=0.15))  # cortico-cortical projection neurons

    return NetworkSpec(areas=areas, groups=[exc, inh], populations=pops,
                       projections=projections, max_delay=max_delay,
                       seed=seed)


def brunel(scale: float = 1.0, g: float = 5.0, eta: float = 2.0, *,
           stdp: bool = False, poisson_input: bool = False,
           seed: int = 11) -> tuple[NetworkSpec, STDPParams | None]:
    """Brunel (2000) sparsely connected E/I network; scale=1 -> 12500.

    ``g`` is the inhibition/excitation balance, ``eta`` the external drive
    relative to the threshold rate - the two axes of Brunel's phase
    diagram (g>4, eta~1: asynchronous-irregular; eta>>1: synchronous-
    regular; large g, low eta: synchronous-irregular).  Delta synapses are
    approximated by the engine's psc_exp with a short time constant, as in
    the NEST reference implementation of the benchmark.

    ``poisson_input=True`` replaces the collapsed per-neuron Poisson rate
    with an explicit emitter population (``"lif+poisson"`` composite,
    DESIGN.md §12) projecting onto E and I through ordinary fixed-indegree
    projections - external drive then rides the ring/wires like any other
    spikes, shard- and host-transparently.
    """
    rng = np.random.default_rng(seed)
    n = max(int(round(12500 * scale)), 25)
    ne, ni = int(0.8 * n), n - int(0.8 * n)
    eps = 0.1
    k_e = max(1, min(int(eps * ne), ne - 1))
    k_i = max(1, min(int(eps * ni), ni - 1))

    lif = LIFParams(tau_m=20.0, c_m=250.0, e_l=-70.0, v_th=-55.0,
                    v_reset=-70.0, t_ref=2.0, tau_syn_ex=0.5,
                    tau_syn_in=0.5)
    je = 32.0                 # ~0.1 mV PSP at these membrane params
    ji = -g * je
    delay_steps = int(round(1.5 / DT_MS))
    max_delay = delay_steps + 1

    # threshold rate: the collapsed input rate whose mean drive reaches
    # theta (same convention as hpc_benchmark)
    nu_thr_hz = 1e3 * (lif.v_th - lif.e_l) * lif.c_m / (
        je * lif.tau_m * lif.tau_syn_ex)
    ext_rate = eta * nu_thr_hz

    area = AreaSpec(name="net", n_neurons=n,
                    positions=_ball(rng, n, (0, 0, 0), 1.0))
    pops = [Population("E", area=0, group=0, n=ne,
                       ext_rate_hz=0.0 if poisson_input else ext_rate,
                       ext_weight=je),
            Population("I", area=0, group=0, n=ni,
                       ext_rate_hz=0.0 if poisson_input else ext_rate,
                       ext_weight=je)]
    projections = [
        Projection(0, 0, k_e, je, 0.0, delay_steps, delay_steps,
                   channel=0, plastic=stdp),
        Projection(0, 1, k_e, je, 0.0, delay_steps, delay_steps, channel=0),
        Projection(1, 0, k_i, ji, 0.0, delay_steps, delay_steps, channel=1),
        Projection(1, 1, k_i, ji, 0.0, delay_steps, delay_steps, channel=1),
    ]
    groups: list = [lif]
    neuron_model = "lif"
    if poisson_input:
        # explicit emitter population: k_ext inputs per target, each at
        # ext_rate / k_ext, so the summed drive matches the collapsed rate
        n_p = max(ne // 8, 64)
        k_ext = min(50, n_p)
        # Bernoulli emitters cap at one spike per dt; keep per-emitter
        # rates safely below 1/dt
        rate_per = min(ext_rate / k_ext, 0.5 / (DT_MS * 1e-3))
        area = AreaSpec(name="net", n_neurons=n + n_p,
                        positions=_ball(rng, n + n_p, (0, 0, 0), 1.0))
        groups.append(PoissonParams(rate_hz=rate_per))
        pops.append(Population("P", area=0, group=1, n=n_p))
        projections += [
            Projection(2, 0, k_ext, je, 0.0, 1, 1, channel=0),
            Projection(2, 1, k_ext, je, 0.0, 1, 1, channel=0),
        ]
        neuron_model = "lif+poisson"
    spec = NetworkSpec(areas=[area], groups=groups, populations=pops,
                       projections=projections, max_delay=max_delay,
                       seed=seed, neuron_model=neuron_model)
    return spec, (HPC_STDP if stdp else None)


# Potjans & Diesmann (2014) cortical microcircuit: population sizes,
# connection probabilities (target row x source column) and external
# indegrees, populations ordered [L23E, L23I, L4E, L4I, L5E, L5I, L6E,
# L6I].  The standard NEST comparison workload; probabilities convert to
# fixed indegrees k = round(p * n_src) at the scaled population sizes.
_PD_POPS = ("L23E", "L23I", "L4E", "L4I", "L5E", "L5I", "L6E", "L6I")
_PD_SIZES = (20683, 5834, 21915, 5479, 4850, 1065, 14395, 2948)
_PD_CONN = (
    (0.1009, 0.1689, 0.0437, 0.0818, 0.0323, 0.0000, 0.0076, 0.0000),
    (0.1346, 0.1371, 0.0316, 0.0515, 0.0755, 0.0000, 0.0042, 0.0000),
    (0.0077, 0.0059, 0.0497, 0.1350, 0.0067, 0.0003, 0.0453, 0.0000),
    (0.0691, 0.0029, 0.0794, 0.1597, 0.0033, 0.0000, 0.1057, 0.0000),
    (0.1004, 0.0622, 0.0505, 0.0057, 0.0831, 0.3726, 0.0204, 0.0000),
    (0.0548, 0.0269, 0.0257, 0.0022, 0.0600, 0.3158, 0.0086, 0.0000),
    (0.0156, 0.0066, 0.0211, 0.0166, 0.0572, 0.0197, 0.0396, 0.2252),
    (0.0364, 0.0010, 0.0034, 0.0005, 0.0277, 0.0080, 0.0658, 0.1443),
)
_PD_EXT_INDEGREE = (1600, 1500, 2100, 1900, 2000, 1900, 2900, 2100)


def microcircuit(scale: float = 1.0, *,
                 seed: int = 17) -> tuple[NetworkSpec, None]:
    """Potjans-Diesmann-style 8-population cortical column (one area).

    scale=1 -> ~77k neurons / ~0.3B synapses (the published column);
    indegrees shrink with the scaled source populations, the external
    drive keeps the published per-population Poisson indegrees at 8 Hz.
    Weights: 87.8 pA +- 10%, g = -4, the L4E -> L2/3E projection doubled
    (the published exception); delays 1.5 +- 0.75 ms exc / 0.75 +- 0.375
    ms inh, discretized to the engine's integer steps.
    """
    rng = np.random.default_rng(seed)
    sizes = [max(int(round(s * scale)), 20) for s in _PD_SIZES]
    n_total = sum(sizes)
    area = AreaSpec(name="column", n_neurons=n_total,
                    positions=_ball(rng, n_total, (0, 0, 0), 1.0))
    exc = LIFParams(tau_m=10.0, c_m=250.0, e_l=-65.0, v_th=-50.0,
                    v_reset=-65.0, t_ref=2.0, tau_syn_ex=0.5,
                    tau_syn_in=0.5)
    je, gbal = 87.8, 4.0
    bg_rate = 8.0
    pops = [Population(name, area=0, group=0, n=sizes[i],
                       ext_rate_hz=bg_rate * _PD_EXT_INDEGREE[i],
                       ext_weight=je)
            for i, name in enumerate(_PD_POPS)]
    d_exc_lo, d_exc_hi = (max(1, int(round(0.75 / DT_MS))),
                          int(round(2.25 / DT_MS)))
    d_inh_lo, d_inh_hi = (max(1, int(round(0.375 / DT_MS))),
                          int(round(1.125 / DT_MS)))
    projections = []
    for tgt in range(8):
        for src in range(8):
            k = int(round(_PD_CONN[tgt][src] * sizes[src]))
            if k < 1:
                continue
            k = min(k, sizes[src] - (1 if src == tgt else 0))
            inhibitory = src % 2 == 1
            w = -gbal * je if inhibitory else je
            if (src, tgt) == (2, 0):   # L4E -> L2/3E: doubled weight
                w = 2.0 * je
            lo, hi = (d_inh_lo, d_inh_hi) if inhibitory else (d_exc_lo,
                                                              d_exc_hi)
            projections.append(Projection(
                src, tgt, k, w, abs(w) * 0.1, lo, hi,
                channel=1 if inhibitory else 0))
    max_delay = d_exc_hi + 1
    spec = NetworkSpec(areas=[area], groups=[exc], populations=pops,
                       projections=projections, max_delay=max_delay,
                       seed=seed)
    return spec, None


def model_demo(neuron_model: str = "lif", scale: float = 1.0, *,
               stdp: bool = False,
               seed: int = 29) -> tuple[NetworkSpec, STDPParams | None]:
    """Balanced E/I network parameterized for any registered NeuronModel -
    the cross-model bench/test workload (``bench_snn --model``).

    scale=1 -> 10000 neurons; the per-model group parameters put each
    model in a tonically active regime driven by ``i_e`` (deterministic -
    so 1-shard vs N-shard trajectories stay bitwise comparable for the
    dynamical models; "poisson" is the stochastic emitter population).
    """
    rng = np.random.default_rng(seed)
    n = max(int(round(10000 * scale)), 30)
    ne, ni = int(0.8 * n), n - int(0.8 * n)
    if neuron_model == "lif":
        groups = [LIFParams(i_e=800.0, t_ref=1.0),
                  LIFParams(i_e=800.0, t_ref=1.0, tau_m=8.0)]
        je, ji = 45.0, -180.0
    elif neuron_model == "izhikevich":
        # regular-spiking E, fast-spiking I (Izhikevich 2003 fig. 2);
        # drive sized for a ~25-step first-spike latency so short smoke
        # runs are never vacuous
        groups = [IzhikevichParams(i_e=12.0, i_scale=0.05),
                  IzhikevichParams(a=0.1, b=0.2, d=2.0, i_e=12.0,
                                   i_scale=0.05)]
        je, ji = 45.0, -180.0
    elif neuron_model == "adex":
        groups = [AdExParams(i_e=1500.0),
                  AdExParams(i_e=1500.0, a=2.0, b=20.0, tau_w=60.0,
                             t_ref=1.0)]
        je, ji = 60.0, -240.0
    elif neuron_model == "poisson":
        groups = [PoissonParams(rate_hz=25.0), PoissonParams(rate_hz=60.0)]
        je, ji = 45.0, -180.0
    else:
        raise ValueError(
            f"no demo parameterization for neuron model {neuron_model!r}")
    area = AreaSpec(name="net", n_neurons=n,
                    positions=_ball(rng, n, (0, 0, 0), 1.0))
    pops = [Population("E", area=0, group=0, n=ne),
            Population("I", area=0, group=1, n=ni)]
    k_e = max(1, min(int(0.1 * ne), ne - 1))
    k_i = max(1, min(int(0.1 * ni), ni - 1))
    projections = [
        Projection(0, 0, k_e, je, 0.1 * je, 1, 5, channel=0, plastic=stdp),
        Projection(0, 1, k_e, je, 0.1 * je, 1, 3, channel=0),
        Projection(1, 0, k_i, ji, 0.1 * abs(ji), 2, 6, channel=1),
        Projection(1, 1, k_i, ji, 0.1 * abs(ji), 1, 2, channel=1),
    ]
    spec = NetworkSpec(areas=[area], groups=groups, populations=pops,
                       projections=projections, max_delay=8, seed=seed,
                       neuron_model=neuron_model)
    return spec, (HPC_STDP if stdp else None)


# --------------------------------------------------------------------------
# scenario registry (the CLI-facing face of the zoo)
# --------------------------------------------------------------------------

_SCENARIOS = {
    "hpc_benchmark": lambda scale=0.02, **kw: hpc_benchmark(scale, **kw),
    "marmoset": lambda scale=0.004, **kw: (marmoset(scale, **kw), None),
    "brunel": lambda scale=0.02, **kw: brunel(scale, **kw),
    "microcircuit": lambda scale=0.01, **kw: microcircuit(scale, **kw),
}


def available_scenarios() -> tuple[str, ...]:
    return tuple(sorted(_SCENARIOS))


def get_scenario(name: str, **kwargs) -> tuple[NetworkSpec,
                                               STDPParams | None]:
    """Build a named scenario -> (spec, stdp).  ``spec.neuron_model`` says
    which registry dynamics interpret ``spec.groups``; drivers thread it
    into ``EngineConfig.neuron_model``.  Unknown kwargs pass through to
    the factory (scale, g, eta, seed, ...)."""
    if name not in _SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}; available: "
                         f"{available_scenarios()}")
    return _SCENARIOS[name](**kwargs)


def scenario_id(spec: NetworkSpec) -> str:
    """Short stable fingerprint of a network's FULL identity.

    Hashes the canonical ``spec_to_dict`` form (the same serialization
    checkpoints embed via ``network_metadata``), so two specs share an id
    iff they describe the same network - the key the session engine uses
    to enforce that every resident instance shares one consts set
    (DESIGN.md §16).  Equal to the reference's id of the same spec."""
    raw = json.dumps(spec_to_dict(spec), sort_keys=True)
    return hashlib.sha256(raw.encode()).hexdigest()[:12]


def resolve_scenario(scenario, **kwargs) -> tuple[NetworkSpec,
                                                  STDPParams | None, str]:
    """Scenario -> ``(spec, stdp, scenario_id)`` - the session plumbing.

    ``scenario`` is a zoo name (kwargs pass through to the factory: scale,
    g, eta, seed, ...) or an already-built :class:`NetworkSpec` (kwargs
    then only admit ``stdp=``).  Either way the returned id fingerprints
    the resolved spec, so callers can compare workload identity without
    caring how the spec was spelled."""
    if isinstance(scenario, NetworkSpec):
        stdp = kwargs.pop("stdp", None)
        if kwargs:
            raise TypeError(
                f"unexpected kwargs {sorted(kwargs)} with an explicit "
                "NetworkSpec (only stdp= applies)")
        spec = scenario
    else:
        spec, stdp = get_scenario(scenario, **kwargs)
    return spec, stdp, scenario_id(spec)


def firing_rate_hz(spikes, n_real: int | None = None) -> float:
    """Mean population firing rate from a (steps, n) spike-bit record
    (numpy array or tensor, on any device)."""
    if isinstance(spikes, torch.Tensor):
        spikes = spikes.cpu().numpy()
    s = np.asarray(spikes)
    steps, n = s.shape
    if n_real is not None:
        s = s[:, :n_real]
        n = n_real
    t_s = steps * DT_MS * 1e-3
    return float(s.sum() / (n * t_s))
