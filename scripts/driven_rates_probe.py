"""The driven networks' rates: the port against the JAX reference.

``hpc_benchmark(1.0, stdp=True)`` and ``microcircuit(0.25)`` run with the
external Poisson drive on, so the port's rates (its own ``torch.Generator``
draws) can only be compared with the reference's statistically.  This
script separates the two questions that comparison mixes:

* ``--compare NAME STEPS`` (the CPU, JAX installed): the reference's
  ``"flat"`` engine from ``jax.random.key(0)`` and the port's ``"flat"``
  engine with the reference's own draws injected, STEPS steps each: the
  first steps whose spikes differ and, after STEPS steps, the largest
  difference of every state leaf; where spikes differ, both run again to
  the first such step and the neurons that disagree are printed with
  their membrane potentials (a rounding flip sits at the threshold)::

      PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/driven_rates_probe.py \\
          --compare microcircuit 300

* ``--dump NAME`` (the CPU, JAX installed): the reference's key-0 drive
  for 2000 steps as event counts (uint8) in
  ``experiments/<NAME>_ref_key0_events.npy``, for the card;

* ``--seeds N`` (the card): the port's ``"cuda"`` engine on each network,
  2000 steps from seeds 0..N-1, then with the dumped reference drive
  injected on ``"cuda"`` and ``"flat"``; one JSON line per run with each
  population's rate per 250-step window and from step 500 on::

      python scripts/driven_rates_probe.py --seeds 16

NAME is ``hpc`` or ``microcircuit``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

STEPS, WINDOW, MEAN_FROM = 2000, 250, 500


def _events_file(name: str) -> str:
    return os.path.join(ROOT, "experiments", f"{name}_ref_key0_events.npy")


def _ref_network(name: str):
    from repro.core import models as ref_models
    from test_torch_engine import _ref_setup
    spec, stdp = (ref_models.hpc_benchmark(1.0, stdp=True) if name == "hpc"
                  else ref_models.microcircuit(0.25))
    return spec, stdp, *_ref_setup(spec)


def dump(name: str) -> None:
    from test_torch_engine import _reference_drives
    _, _, g, _, st = _ref_network(name)
    d = _reference_drives(g, st, STEPS)
    w = np.asarray(g.ext_weight, np.float32)
    ev = np.where(w > 0, d / np.where(w > 0, w, 1), 0)
    assert np.allclose(ev, np.round(ev)) and ev.max() < 255
    os.makedirs(os.path.dirname(_events_file(name)), exist_ok=True)
    np.save(_events_file(name), np.round(ev).astype(np.uint8))
    print(json.dumps({"dumped": _events_file(name), "shape": ev.shape}))


def compare(name: str, n: int) -> None:
    import jax
    import torch
    from repro.core import engine as ref_engine
    from repro_torch import convert
    from repro_torch.core import engine, models
    from test_torch_engine import (_live_mirrors, _port_graph, _ref_leaves,
                                   _reference_drives)
    spec, stdp, g_ref, table_ref, st_ref = _ref_network(name)
    gd = g_ref.device_arrays()
    drive = torch.from_numpy(_reference_drives(g_ref, st_ref, n))
    g = _port_graph(g_ref)
    table = torch.from_numpy(np.array(table_ref))

    def both(k):
        cfg_ref = ref_engine.EngineConfig(dt=0.1, stdp=stdp, sweep="flat")
        fr, sr = jax.jit(
            lambda s: ref_engine.run(s, gd, table_ref, cfg_ref, k))(st_ref)
        cfg = engine.EngineConfig(
            dt=0.1, stdp=None if stdp is None else models.HPC_STDP,
            sweep="flat")
        st = convert.state_from_numpy(_ref_leaves(st_ref), g, sweep="flat",
                                      device="cpu")
        fp, sp = engine.run(st, g, table, cfg, k, drive=drive[:k],
                            device="cpu")
        return fr, np.asarray(sr), fp, sp.numpy()

    fr, sr, fp, sp = both(n)
    differ = np.nonzero((sr != sp).any(1))[0]
    live = _live_mirrors(g_ref)
    ref = {k: np.asarray(v) for k, v in _ref_leaves(fr).items()}
    port = {"neurons.v_m": fp.neurons.v_m, "neurons.syn_ex":
            fp.neurons.syn_ex, "neurons.syn_in": fp.neurons.syn_in,
            "weights": fp.weights, "traces.k_pre": fp.traces.k_pre,
            "traces.k_post": fp.traces.k_post}
    diffs = {}
    for k, a in port.items():
        a, b = a.numpy().astype(np.float64), ref[k].astype(np.float64)
        if k == "traces.k_pre":
            a, b = a[live], b[live]
        diffs[k] = float(np.abs(a - b).max())
    rec = {"network": name, "steps": n,
           "first_differing_steps": differ[:8].tolist(),
           "max_abs_diff_after": diffs}
    if len(differ):
        k = int(differ[0])
        fr, sr, fp, sp = both(k + 1)
        idx = np.nonzero(sr[k] != sp[k])[0]
        vr, vp = np.asarray(fr.neurons.v_m), fp.neurons.v_m.numpy()
        rest = np.ones(len(vr), bool)
        rest[idx] = False
        rec["flip"] = {"step": k, "neurons": [
            {"neuron": int(i), "ref_spike": bool(sr[k, i]),
             "ref_v": float(vr[i]), "port_spike": bool(sp[k, i]),
             "port_v": float(vp[i])} for i in idx[:10]],
            "max_abs_dv_elsewhere": float(
                np.abs(vr[rest].astype(np.float64) - vp[rest]).max())}
    print(json.dumps(rec), flush=True)


def seeds(n_seeds: int) -> None:
    import torch
    from repro_torch.core import builder, engine, models, snn
    dev = torch.device("cuda")
    for name in ("microcircuit", "hpc"):
        spec, stdp = (models.hpc_benchmark(1.0, stdp=True) if name == "hpc"
                      else models.microcircuit(0.25))
        g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(dev)
        table = snn.make_param_table(list(spec.groups), models.DT_MS,
                                     device=dev)
        ev = np.load(_events_file(name))
        ref_drive = torch.from_numpy(ev.astype(np.float32)).to(dev) \
            * g.ext_weight
        plan = [("cuda", f"seed{s}", s, None) for s in range(n_seeds)]
        plan += [("cuda", "ref_key0_drive", 0, ref_drive),
                 ("flat", "ref_key0_drive", 0, ref_drive)]
        off = spec.pop_offsets()
        for sweep, label, seed, drive in plan:
            cfg = engine.EngineConfig(dt=models.DT_MS, stdp=stdp,
                                      sweep=sweep)
            st = engine.init_state(g, list(spec.groups), seed, device=dev)
            t0 = time.perf_counter()
            _, sp = engine.run(st, g, table, cfg, STEPS, drive=drive,
                               device=dev)
            wall = time.perf_counter() - t0
            sp = sp.cpu().numpy()
            rates = {p.name: {
                "per_window_hz": [
                    models.firing_rate_hz(sp[j:j + WINDOW, off[i]:off[i + 1]])
                    for j in range(0, STEPS, WINDOW)],
                "mean_hz": models.firing_rate_hz(
                    sp[MEAN_FROM:, off[i]:off[i + 1]])}
                for i, p in enumerate(spec.populations)}
            print(json.dumps({"network": name, "sweep": sweep, "run": label,
                              "wall_s": wall, "rates": rates}), flush=True)
        del g, table, ref_drive
        torch.cuda.empty_cache()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", nargs=2, metavar=("NAME", "STEPS"))
    ap.add_argument("--dump", choices=("hpc", "microcircuit"))
    ap.add_argument("--seeds", type=int)
    args = ap.parse_args(argv)
    if args.dump:
        dump(args.dump)
    if args.compare:
        compare(args.compare[0], int(args.compare[1]))
    if args.seeds:
        seeds(args.seeds)


if __name__ == "__main__":
    main()
