"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

The main path is the paper's verification case (§IV.A): NEST's
``hpc_benchmark`` with pl-STDP at scale 1 (11 250 neurons, 12.66 M
synapses), built on one shard and stepped by ``engine.run`` through the
``"cuda"`` backend, whose three kernels are hand-written CUDA C++ for
Hopper (``src/repro_torch/kernels/csrc/``).  Phases, one JSON line each:

1. device   - the card (``nvidia-smi``) and the kernels' build time;
2. kernel   - K1, K2, K3 at the main path's shapes on seeded random inputs:
              each against its plain-torch twin (tolerance printed), twice
              for bitwise determinism, timed with CUDA events;
3. lockstep - 120 steps of scale 1 where the ``"cuda"`` and ``"flat"``
              backends start every step from the same state and drive;
4. mixed    - 120 free-running steps of a small mixed network, drive off:
              identical spike rasters on both backends;
5. main     - 2000 steps of scale 1 through ``engine.run``: every kernel
              launched once per step, weights bounded, state finite, rate
              in the asynchronous-irregular band; then a profiled window.

Then one line with every kernel's numbers, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  Any failed check raises, and
the script exits non-zero without that last line.  Without a CUDA device
it exits non-zero at once.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() "
             "is False")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.core import backends, builder, engine, models, snn  # noqa: E402
from repro_torch.core.decomposition import AreaSpec  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import lif_step as lif_mod  # noqa: E402
from repro_torch.kernels import stdp_update as stdp_mod  # noqa: E402
from repro_torch.kernels import synaptic_gather as gather_mod  # noqa: E402

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
SEED = 0
SLEEP_CYCLES = 10_000_000      # ~5 ms at H100 clocks: covers one enqueue
KERNEL_FNS = {"synaptic_gather": gather_mod.synaptic_gather,
              "lif_step": lif_mod.lif_step,
              "stdp_update": stdp_mod.stdp_update}
REPLACES = {"synaptic_gather": "src/repro/kernels/synaptic_gather.py:106",
            "lif_step": "src/repro/kernels/lif_step.py:71",
            "stdp_update": "src/repro/kernels/stdp_update.py:66"}


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def median_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call of ``fn`` over ``reps`` calls.

    CUDA events bracket each call; a sleep kernel ahead of them keeps the
    stream busy while the host validates and enqueues the call, so the
    events time the device work and not the Python in front of it.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


# --------------------------------------------------------------------------
# phase 1: device
# --------------------------------------------------------------------------

def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    built = _build.build_all()
    emit({"phase": "device", "card": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": built["seconds"]})
    return smi


# --------------------------------------------------------------------------
# phase 2: each kernel at the main path's shapes
# --------------------------------------------------------------------------

def phase_kernels(g) -> dict:
    rng = np.random.default_rng(SEED)
    bg = g.blocked
    nb, eb, pb, d, m = bg.nb, bg.eb, bg.pb, g.max_delay, g.n_mirror
    out = {}
    live = int((bg.delay > 0).sum())

    # K1: the edge pass on the built layout, random weights/ring/fresh
    bounds = gather_mod.segment_bounds(bg.post_rel, bg.delay, pb=pb,
                                       max_delay=d)
    w = torch.from_numpy(rng.normal(0, 50, (nb, eb)).astype(np.float32)
                         ).to(DEV)
    ring = torch.from_numpy((rng.uniform(size=(d, m)) < 0.05)
                            .astype(np.float32)).to(DEV)
    fresh = torch.from_numpy((rng.uniform(size=m) < 0.05)
                             .astype(np.float32)).to(DEV)
    t = torch.tensor(7, dtype=torch.int32, device=DEV)   # t < D: floor-mod
    args = (bg.pre_idx, bg.post_rel, w, bg.delay, bg.channel, ring, t)
    errs = {}
    for name, fr in (("no_fresh", None), ("fresh", fresh)):
        k1 = gather_mod.synaptic_gather(*args, max_delay=d, pb=pb, fresh=fr,
                                        bounds=bounds)
        k2 = gather_mod.synaptic_gather(*args, max_delay=d, pb=pb, fresh=fr,
                                        bounds=bounds)
        pl = gather_mod.synaptic_gather_plain(*args, max_delay=d, pb=pb,
                                              fresh=fr)
        check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
              f"K1 ({name}) not bitwise deterministic")
        check(torch.equal(k1[2], pl[2]), f"K1 ({name}) arrivals differ")
        errs[name] = max(max_abs(k1[0], pl[0]), max_abs(k1[1], pl[1]))
        check(errs[name] <= 1e-2, f"K1 ({name}) sums differ by "
              f"{errs[name]}")
    k_ms = median_ms(lambda: gather_mod.synaptic_gather(
        *args, max_delay=d, pb=pb, bounds=bounds))
    p_ms = median_ms(lambda: gather_mod.synaptic_gather_plain(
        *args, max_delay=d, pb=pb))
    nbytes = (live * 12 + bounds.numel() * 4 + d * m * 4 + 4
              + 2 * nb * pb * 4 + nb * eb * 4)
    b_ms, b_by = bound(nbytes, 2 * live)
    out["synaptic_gather"] = dict(max_abs_err=max(errs.values()), ms=k_ms,
                                  plain_ms=p_ms, bound_ms=b_ms,
                                  bound_by=b_by, bytes=nbytes)
    emit({"phase": "kernel", "name": "synaptic_gather", "nb": nb, "eb": eb,
          "pb": pb, "d": d, "m": m, "live_slots": live,
          "max_abs_err": errs, "tolerance": "arrivals exact; sums atol 1e-2",
          "deterministic": True, "kernel_ms": k_ms, "plain_ms": p_ms,
          "bound_ms": b_ms, "bytes": nbytes})

    # K2: the LIF update over the main path's n_local neurons
    n = g.n_local
    f32 = lambda lo, hi: torch.from_numpy(
        rng.uniform(lo, hi, n).astype(np.float32)).to(DEV)
    table = snn.make_param_table([snn.LIFParams(t_ref=0.5),
                                  snn.LIFParams(tau_m=8.0)], models.DT_MS,
                                 device=DEV)
    largs = (f32(-52, -48), f32(0, 100), f32(0, 100),
             torch.from_numpy(rng.integers(0, 4, n).astype(np.int32)).to(DEV),
             torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)).to(DEV),
             f32(0, 500), f32(0, 50), table)
    errs = {}
    for cond in (False, True):
        k1 = lif_mod.lif_step(*largs, cond=cond)
        k2 = lif_mod.lif_step(*largs, cond=cond)
        pl = lif_mod.lif_step_plain(*largs, cond=cond)
        check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
              "K2 not bitwise deterministic")
        check(k1[4].any(), "K2 inputs spiked nowhere - vacuous")
        check(all(torch.equal(a, b) for a, b in zip(k1, pl)),
              f"K2 (cond={cond}) differs from its twin")
        errs[f"cond={cond}"] = max(max_abs(a.float(), b.float())
                                   for a, b in zip(k1, pl))
    k_ms = median_ms(lambda: lif_mod.lif_step(*largs))
    p_ms = median_ms(lambda: lif_mod.lif_step_plain(*largs))
    nbytes = n * (5 * 4 + 2 * 4) + table.numel() * 4 + n * (4 * 4 + 1)
    b_ms, b_by = bound(nbytes, 15 * n)
    out["lif_step"] = dict(max_abs_err=max(errs.values()), ms=k_ms,
                           plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                           bytes=nbytes)
    emit({"phase": "kernel", "name": "lif_step", "n": n,
          "max_abs_err": errs, "tolerance": "bitwise equal",
          "deterministic": True, "kernel_ms": k_ms, "plain_ms": p_ms,
          "bound_ms": b_ms, "bytes": nbytes})

    # K3: the blocked pl-STDP update over every slot
    e = nb * eb
    n_plastic = int(bg.plastic.sum())
    sargs = (torch.from_numpy(rng.uniform(1, 100, e).astype(np.float32)
                              ).to(DEV),
             bg.pre_idx.reshape(-1), bg.post_rel.reshape(-1),
             bg.plastic.reshape(-1),
             torch.from_numpy((rng.uniform(size=e) < 0.05)
                              .astype(np.float32)).to(DEV),
             (torch.rand(n, device=DEV) < 0.05).float(),
             torch.rand(m, device=DEV) * 3, torch.rand(n, device=DEV) * 3)
    params = (models.HPC_STDP.lam, models.HPC_STDP.alpha, models.HPC_STDP.mu,
              models.HPC_STDP.w0, models.HPC_STDP.w_min,
              models.HPC_STDP.w_max)
    k1 = stdp_mod.stdp_update(*sargs, params=params, eb=eb, pb=pb)
    k2 = stdp_mod.stdp_update(*sargs, params=params, eb=eb, pb=pb)
    pl = stdp_mod.stdp_update_plain(*sargs, params=params, eb=eb, pb=pb)
    check(torch.equal(k1, k2), "K3 not bitwise deterministic")
    check(not torch.equal(k1, sargs[0]), "K3 changed nothing - vacuous")
    err = max_abs(k1, pl)
    check(torch.allclose(k1, pl, rtol=2e-6, atol=0),
          f"K3 differs from its twin by {err}")
    k_ms = median_ms(lambda: stdp_mod.stdp_update(*sargs, params=params,
                                                  eb=eb, pb=pb))
    p_ms = median_ms(lambda: stdp_mod.stdp_update_plain(
        *sargs, params=params, eb=eb, pb=pb))
    nbytes = (n_plastic * 17 + (e - n_plastic) * 5 + e * 4
              + (2 * n + m) * 4)
    b_ms, b_by = bound(nbytes, 20 * n_plastic)
    out["stdp_update"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                              bound_ms=b_ms, bound_by=b_by, bytes=nbytes)
    emit({"phase": "kernel", "name": "stdp_update", "slots": e,
          "plastic_slots": n_plastic, "max_abs_err": err,
          "tolerance": "rtol 2e-6 (expf/logf vs torch exp/log)",
          "deterministic": True, "kernel_ms": k_ms, "plain_ms": p_ms,
          "bound_ms": b_ms, "bytes": nbytes})
    return out


# --------------------------------------------------------------------------
# phase 3: lockstep parity of the two backends at scale 1
# --------------------------------------------------------------------------

def phase_lockstep(spec, stdp, g, table, n_steps: int = 120) -> None:
    cb, fb = backends.get_backend("cuda"), backends.get_backend("flat")
    lc, lf = cb.prepare(g), fb.prepare(g)
    cfg_c = engine.EngineConfig(dt=models.DT_MS, stdp=stdp, sweep="cuda")
    cfg_f = dataclasses.replace(cfg_c, sweep="flat")
    st = engine.init_state(g, list(spec.groups), SEED, sweep="cuda",
                           device=DEV)
    # from rest the network is nearly silent for ~250 steps: start from a
    # seeded random membrane state around threshold instead
    v0 = np.random.default_rng(SEED + 1).uniform(-56.0, -49.5, g.n_local)
    st = dataclasses.replace(st, neurons=dataclasses.replace(
        st.neurons, v_m=torch.from_numpy(v0.astype(np.float32)).to(DEV)))
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 1)
    col = lambda name: table[0, snn.COL[name]]
    v_tol, n_near, n_flip, n_spk = 1e-3, 0, 0, 0
    worst = dict(i_ex=0.0, i_in=0.0, v_m=0.0, weights=0.0, k_pre=0.0,
                 k_post=0.0)
    real = g.delay > 0
    for _ in range(n_steps):
        stf = engine.state_with_weights_layout(st, g, "flat")
        drive = g.ext_weight * torch.poisson(g.ext_rate * (models.DT_MS
                                                           * 1e-3),
                                             generator=gen)
        ex_c, in_c, _ = cb.sweep(lc, st.weights, st.ring, st.t)
        ex_f, in_f, _ = fb.sweep(lf, stf.weights, stf.ring, stf.t)
        new_c, sp_c = engine.engine_step(st, g, table, cfg_c, drive=drive)
        new_f, sp_f = engine.engine_step(stf, g, table, cfg_f, drive=drive)
        nv = st.neurons
        v_prop = (nv.v_m * col("p_vv") + nv.syn_ex * col("p_ve")
                  + nv.syn_in * col("p_vi") + col("p_vconst"))
        near = ((v_prop - col("v_th")).abs() < v_tol) & (nv.ref_count == 0)
        flip = sp_c != sp_f
        check(not bool((flip & ~near).any()),
              "lockstep: spikes differ away from the threshold")
        n_near += int(near.sum())
        n_flip += int(flip.sum())
        n_spk += int(sp_c.sum())
        same = ~flip
        wc = engine.state_with_weights_layout(new_c, g, "flat").weights
        for key, a, b in (
                ("i_ex", ex_c, ex_f), ("i_in", in_c, in_f),
                ("v_m", new_c.neurons.v_m[same], new_f.neurons.v_m[same]),
                ("weights", wc[real], new_f.weights[real]),
                ("k_pre", new_c.traces.k_pre, new_f.traces.k_pre),
                ("k_post", new_c.traces.k_post, new_f.traces.k_post)):
            worst[key] = max(worst[key], max_abs(a, b))
        st = new_c          # continue from the kernel path's state
    tol = dict(i_ex=1e-2, i_in=1e-2, v_m=1e-4, weights=1e-4, k_pre=1e-5,
               k_post=1e-5)
    for key, lim in tol.items():
        check(worst[key] <= lim, f"lockstep: {key} differs by {worst[key]}"
              f" > {lim}")
    check(n_spk > 0, "lockstep: nothing spiked - vacuous")
    emit({"phase": "lockstep", "steps": n_steps, "spikes": n_spk,
          "near_threshold": n_near, "flipped": n_flip,
          "v_threshold_tol_mV": v_tol, "max_abs_err": worst,
          "tolerance": tol})


# --------------------------------------------------------------------------
# phase 4: free-running parity on a small mixed network
# --------------------------------------------------------------------------

def mixed_backend_spec():
    """Copy of tests/test_snn_engine.py::mixed_backend_spec: two groups,
    mixed channels, heterogeneous delays, plastic E->E edges, padding."""
    ne, ni = 24, 9
    area = AreaSpec("a", ne + ni, positions=np.zeros((ne + ni, 3)))
    exc = snn.LIFParams(i_e=800.0, t_ref=1.0)
    inh = snn.LIFParams(i_e=800.0, t_ref=1.0, tau_m=8.0)
    pops = [builder.Population("E", 0, 0, ne),
            builder.Population("I", 0, 1, ni)]
    projections = [
        builder.Projection(0, 0, 5, 45.0, 5.0, 1, 5, channel=0,
                           plastic=True),
        builder.Projection(0, 1, 3, 45.0, 5.0, 1, 3, channel=0),
        builder.Projection(1, 0, 4, -200.0, 10.0, 2, 6, channel=1),
        builder.Projection(1, 1, 2, -200.0, 10.0, 1, 2, channel=1),
    ]
    return builder.NetworkSpec(areas=[area], groups=[exc, inh],
                               populations=pops, projections=projections,
                               max_delay=8, seed=3)


def phase_mixed(n_steps: int = 120) -> None:
    spec = mixed_backend_spec()
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(DEV)
    table = snn.make_param_table(list(spec.groups), models.DT_MS,
                                 device=DEV)
    res = {}
    for sweep in ("cuda", "flat"):
        cfg = engine.EngineConfig(dt=models.DT_MS, stdp=models.HPC_STDP,
                                  sweep=sweep, external_drive=False)
        st = engine.init_state(g, list(spec.groups), SEED, device=DEV)
        res[sweep] = engine.run(st, g, table, cfg, n_steps, device=DEV)
    (fc, sc), (ff, sf) = res["cuda"], res["flat"]
    check(int(sf.sum()) > 10, "mixed: nothing spiked - vacuous")
    check(bool((g.delay == 0).any()), "mixed: no padding edges - vacuous")
    check(torch.equal(sc, sf), "mixed: spike rasters differ")
    err = max_abs(fc.weights, ff.weights)
    check(err <= 1e-4, f"mixed: weights differ by {err}")
    emit({"phase": "mixed", "steps": n_steps, "spikes": int(sc.sum()),
          "rasters_identical": True, "weights_max_abs_err": err,
          "tolerance": 1e-4})


# --------------------------------------------------------------------------
# phase 5: the main path
# --------------------------------------------------------------------------

def _profile(g, table, cfg, spec, n_steps: int = 50) -> dict:
    """Device time by kernel over a short steady window."""
    from torch.profiler import ProfilerActivity, profile
    st = engine.init_state(g, list(spec.groups), SEED + 2, sweep="cuda",
                           device=DEV)
    st, _ = engine.run(st, g, table, cfg, 5, device=DEV)   # warm
    st = engine.state_with_weights_layout(st, g, "blocked",
                                          backend=backends.get_backend("cuda"))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            st, _ = engine.engine_step(st, g, table, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue     # CPU ops: their kernels are listed on their own
        dt = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        name = ev.key.replace("(anonymous namespace)::", "")[:60]
        by_name[name] = by_name.get(name, 0.0) + dt / 1e3
    busy = sum(by_name.values())
    check(busy > 0, "profile: no device time traced")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"steps": n_steps,
            "wall_ms_per_step_profiled": wall * 1e3 / n_steps,
            "device_ms_per_step": busy / n_steps,
            "device_idle_share": 1 - busy / (wall * 1e3),
            "kernels_per_step": sum(
                e.count for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")) / n_steps,
            "ms_per_step_by_kernel": {k: v / n_steps for k, v in top}}


def phase_main(spec, stdp, g, table, n_steps: int = 2000) -> dict:
    cfg = engine.EngineConfig(dt=models.DT_MS, stdp=stdp, sweep="cuda")
    st = engine.init_state(g, list(spec.groups), SEED, device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in KERNEL_FNS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    fin, spikes = engine.run(st, g, table, cfg, n_steps, device=DEV)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in KERNEL_FNS.items()}
    peak = torch.cuda.max_memory_allocated()
    for k, c in launches.items():
        check(c == n_steps, f"main: {k} launched {c} times in {n_steps} "
              "steps")
    w = fin.weights
    plastic = g.plastic & (g.delay > 0)
    fixed = ~g.plastic & (g.delay > 0)
    check(bool(((w[plastic] >= stdp.w_min) & (w[plastic] <= stdp.w_max))
               .all()), "main: plastic weights left [w_min, w_max]")
    check(torch.equal(w[fixed], g.weight_init[fixed]),
          "main: a non-plastic weight changed")
    for name, x in (("v_m", fin.neurons.v_m), ("syn_ex", fin.neurons.syn_ex),
                    ("syn_in", fin.neurons.syn_in), ("weights", w),
                    ("k_pre", fin.traces.k_pre),
                    ("k_post", fin.traces.k_post), ("ring", fin.ring)):
        check(bool(torch.isfinite(x).all()), f"main: {name} not finite")
    rate = models.firing_rate_hz(spikes[500:], spec.n_neurons)
    check(3.0 <= rate <= 15.0, f"main: rate {rate} Hz outside [3, 15]")
    windows = [models.firing_rate_hz(spikes[i:i + 250], spec.n_neurons)
               for i in range(0, n_steps, 250)]
    prof = _profile(g, table, cfg, spec)
    emit({"phase": "main", "steps": n_steps, "neurons": spec.n_neurons,
          "synapses": int((g.delay > 0).sum()),
          "plastic_synapses": int(plastic.sum()),
          "rate_hz_500_2000": rate, "rate_hz_per_250_steps": windows,
          "plastic_w_min": float(w[plastic].min()),
          "plastic_w_max": float(w[plastic].max()),
          "inhibitory_w": float(w[fixed].min()),
          "wall_s": wall, "steps_per_s": n_steps / wall,
          "peak_device_mem_bytes": peak, "launches": launches,
          "profile": prof})
    return launches


def main() -> None:
    smi = phase_device()
    t0 = time.perf_counter()
    spec, stdp = models.hpc_benchmark(1.0, stdp=True)
    g_host = builder.build_shards(spec, builder.decompose(spec, 1))[0]
    g = g_host.to(DEV)
    del g_host
    table = snn.make_param_table(list(spec.groups), models.DT_MS, device=DEV)
    emit({"phase": "build", "neurons": spec.n_neurons, "n_local": g.n_local,
          "edges": int((g.delay > 0).sum()), "nb": g.blocked.nb,
          "eb": g.blocked.eb, "pb": g.blocked.pb, "max_delay": g.max_delay,
          "host_build_s": time.perf_counter() - t0})
    kern = phase_kernels(g)
    phase_lockstep(spec, stdp, g, table)
    phase_mixed()
    launches = phase_main(spec, stdp, g, table)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{name}.cu",
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"],
         "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"], "library_ms": None}
        for name in KERNEL_FNS]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
