"""Firing rates of the zoo networks under the JAX reference, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_zoo_rates.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_zoo_rates.py \
        --only hpc_benchmark microcircuit

Runs the reference engine (``src/repro``, ``sweep="flat"``) for 2000 steps
on the networks that ``chip_smoke.py`` drives through the port on the card
and holds to the reference's rates:

- ``model_demo("izhikevich", 1.0, stdp=True)``,
  ``model_demo("adex", 1.0, stdp=True)`` and
  ``brunel(1.0, poisson_input=True)``, from ``jax.random.key(0)``, external
  drive off (none of them has a per-neuron drive rate);
- ``hpc_benchmark(1.0, stdp=True)`` and ``microcircuit(0.25)``, external
  drive on (both need it), from ``jax.random.key(0)`` to ``key(5)``: the
  drive's draws differ from the port's, so only the keys' spread says how
  far a correct run may stray.  Two keys were too few: keys 2-5 leave the
  band of keys 0 and 1 themselves (microcircuit's L2/3I in the onset
  window in all four, hpc's mean rate in key 4).

For every population (and key) it records the rate per 250-step window and
over steps 500 to the end, prints one JSON line per network and writes
them to ``reference_zoo_rates.json`` beside this script; ``--only`` runs
the named networks and merges them into the file.  ``chip_smoke.py`` reads
that file: it runs each network at the recorded scale and length and holds
the port's rates to bands around these.  The model_demo networks are
deterministic, so the port's trajectory on the card follows this one until
ulps of the kernels' arithmetic grow; the composite draws its emitters from
``jax.random``, so only its statistics compare with the port's.  About 11
minutes on one CPU for the first three, 25 for the two driven networks.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import jax
import numpy as np

from repro.core import builder, engine, models, neuron_models

SCALE = 1.0
STEPS = 2000
WINDOW = 250          # steps per rate window
MEAN_FROM = 500       # the mean rate is taken over steps MEAN_FROM..STEPS
#: microcircuit(1.0) has about 285 M synapses; 0.25 is a column of
#: hpc_benchmark's size (19 292 neurons, 17.8 M synapses)
MICROCIRCUIT_SCALE = 0.25
DRIVEN_KEYS = (0, 1, 2, 3, 4, 5)
OUT = Path(__file__).with_suffix(".json")


def networks():
    """``(name, (spec, stdp), external_drive, keys)`` per network."""
    yield ("izhikevich", models.model_demo("izhikevich", SCALE, stdp=True),
           False, (0,))
    yield "adex", models.model_demo("adex", SCALE, stdp=True), False, (0,)
    yield ("lif+poisson", models.brunel(SCALE, poisson_input=True), False,
           (0,))
    yield ("hpc_benchmark", models.hpc_benchmark(SCALE, stdp=True), True,
           DRIVEN_KEYS)
    yield ("microcircuit", models.microcircuit(MICROCIRCUIT_SCALE), True,
           DRIVEN_KEYS)


def rates(spec, spikes: np.ndarray) -> dict:
    off = spec.pop_offsets()
    out = {}
    for i, pop in enumerate(spec.populations):
        s = spikes[:, off[i]:off[i + 1]]
        out[pop.name] = {
            "per_window_hz": [models.firing_rate_hz(s[j:j + WINDOW])
                              for j in range(0, len(s), WINDOW)],
            "mean_hz": models.firing_rate_hz(s[MEAN_FROM:]),
        }
    return out


def record(name, spec, stdp, drive: bool, keys) -> dict:
    t0 = time.perf_counter()
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0]
    gd = g.device_arrays()
    table = neuron_models.get_model(spec.neuron_model).make_param_table(
        list(spec.groups), dt=models.DT_MS)
    cfg = engine.EngineConfig(dt=models.DT_MS, stdp=stdp, sweep="flat",
                              external_drive=drive,
                              neuron_model=spec.neuron_model)
    run = jax.jit(lambda s: engine.run(s, gd, table, cfg, STEPS))
    rec = {"network": name, "scale": spec_scale(name), "steps": STEPS,
           "window_steps": WINDOW, "mean_from_step": MEAN_FROM,
           "external_drive": drive, "neurons": spec.n_neurons,
           "synapses": int((np.asarray(g.delay) > 0).sum()),
           "host_build_s": time.perf_counter() - t0}
    by_key = {}
    for key in keys:
        st = engine.init_state(gd, list(spec.groups), jax.random.key(key),
                               neuron_model=spec.neuron_model)
        t0 = time.perf_counter()
        _, spikes = run(st)
        spikes = np.asarray(spikes)[:, :spec.n_neurons]
        by_key[str(key)] = {
            "mean_hz": models.firing_rate_hz(spikes[MEAN_FROM:]),
            "populations": rates(spec, spikes),
            "cpu_run_s": time.perf_counter() - t0}
    if len(keys) == 1:
        rec.update(by_key[str(keys[0])])
    else:
        rec["keys"] = list(keys)
        rec["by_key"] = by_key
    return rec


def spec_scale(name: str) -> float:
    return MICROCIRCUIT_SCALE if name == "microcircuit" else SCALE


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="+", default=None,
                    help="run these networks and merge them into the file")
    args = ap.parse_args(argv)
    records = (json.loads(OUT.read_text())
               if args.only and OUT.exists() else {})
    for name, (spec, stdp), drive, keys in networks():
        if args.only and name not in args.only:
            continue
        rec = record(name, spec, stdp, drive, keys)
        print(json.dumps(rec), flush=True)
        records[name] = rec
    OUT.write_text(json.dumps(records, indent=1) + "\n")


if __name__ == "__main__":
    main()
