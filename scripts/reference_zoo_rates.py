"""Firing rates of the zoo networks under the JAX reference, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_zoo_rates.py

Runs the reference engine (``src/repro``, ``sweep="flat"``) on the three
networks that ``chip_smoke.py`` drives through the port on the card -
``model_demo("izhikevich", 1.0, stdp=True)``,
``model_demo("adex", 1.0, stdp=True)`` and
``brunel(1.0, poisson_input=True)`` - for 2000 steps from
``jax.random.key(0)``, external drive off (none of them has a per-neuron
drive rate).  For every population it records the rate per 250-step window
and over steps 500 to the end, prints one JSON line per network and writes
all of them to ``reference_zoo_rates.json`` beside this script.
``chip_smoke.py`` reads that file: it runs each network at the recorded
scale and length and holds the port's rates to bands around these.  The
model_demo networks are deterministic, so the port's trajectory on the card
follows this one until ulps of the kernels' arithmetic grow; the composite
draws its emitters from ``jax.random``, so only its statistics compare with
the port's.  About 11 minutes on one CPU.
"""

from __future__ import annotations

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
OUT = Path(__file__).with_suffix(".json")


def networks():
    yield "izhikevich", models.model_demo("izhikevich", SCALE, stdp=True)
    yield "adex", models.model_demo("adex", SCALE, stdp=True)
    yield "lif+poisson", models.brunel(SCALE, poisson_input=True)


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


def main() -> None:
    records = {}
    for name, (spec, stdp) in networks():
        t0 = time.perf_counter()
        g = builder.build_shards(spec, builder.decompose(spec, 1))[0]
        gd = g.device_arrays()
        table = neuron_models.get_model(spec.neuron_model).make_param_table(
            list(spec.groups), dt=models.DT_MS)
        cfg = engine.EngineConfig(dt=models.DT_MS, stdp=stdp, sweep="flat",
                                  external_drive=False,
                                  neuron_model=spec.neuron_model)
        st = engine.init_state(gd, list(spec.groups), jax.random.key(0),
                               neuron_model=spec.neuron_model)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, spikes = jax.jit(
            lambda s: engine.run(s, gd, table, cfg, STEPS))(st)
        spikes = np.asarray(spikes)[:, :spec.n_neurons]
        rec = {"network": name, "scale": SCALE, "steps": STEPS,
               "window_steps": WINDOW, "mean_from_step": MEAN_FROM,
               "neurons": spec.n_neurons,
               "synapses": int((np.asarray(g.delay) > 0).sum()),
               "mean_hz": models.firing_rate_hz(spikes[MEAN_FROM:]),
               "populations": rates(spec, spikes),
               "host_build_s": build_s,
               "cpu_run_s": time.perf_counter() - t0}
        print(json.dumps(rec), flush=True)
        records[name] = rec
    OUT.write_text(json.dumps(records, indent=1) + "\n")


if __name__ == "__main__":
    main()
