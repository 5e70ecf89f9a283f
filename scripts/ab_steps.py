"""Steps per second and the device profile of the port's LIF, Izhikevich and
AdEx main paths, for one or more checkouts of this repository, in turns, on
one card.

    python3 scripts/ab_steps.py ROOT [ROOT ...]

Each ROOT is a checkout (a directory holding ``src/repro_torch``), run in
a process of its own, in the order given: to compare two trees on one
card, give them in turns, ``parent change change parent``.  Each process
builds its tree's kernels, then, for each network,

* ``hpc``:  ``hpc_benchmark(1.0, stdp=True)`` with the external drive on
  (``chip_smoke.py``'s ``main``);
* ``izh``:  ``model_demo("izhikevich", 1.0, stdp=True)`` with the drive
  off (``chip_smoke.py``'s izhikevich ``zoo_main``);
* ``adex``: ``model_demo("adex", 1.0, stdp=True)`` with the drive off
  (``chip_smoke.py``'s adex ``zoo_main``);

runs 20 warm-up steps, then ``engine.run`` for 2000 steps from seed 0
(wall clock around it, ending in a synchronise: steps/s), then the same
run again under ``torch.profiler`` (device ms and kernel launches per
step, by kernel, and the device's idle share under the profiler).  The SHA-256 of each run's spike raster is
printed too: two trees that compute the same trajectory print the same
hash.  One JSON line per (root, network) goes to standard output.  Needs
a CUDA device; imports no JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

STEPS, WARM, SEED = 2000, 20, 0


def child(root: str) -> None:
    """Measure the tree at ``root`` (in this process) and print its lines."""
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import backends, builder, engine, models
    from repro_torch.core import neuron_models
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        sys.exit("ab_steps.py needs a CUDA device")
    dev = torch.device("cuda")
    _build.build_all()
    nets = {"hpc": (models.hpc_benchmark(1.0, stdp=True), True),
            "izh": (models.model_demo("izhikevich", 1.0, stdp=True), False),
            "adex": (models.model_demo("adex", 1.0, stdp=True), False)}
    for name, ((spec, stdp), drive) in nets.items():
        g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(dev)
        table = neuron_models.get_model(spec.neuron_model).make_param_table(
            list(spec.groups), models.DT_MS, device=dev)
        cfg = engine.EngineConfig(dt=models.DT_MS, stdp=stdp, sweep="cuda",
                                  external_drive=drive,
                                  neuron_model=spec.neuron_model)
        init = lambda: engine.init_state(g, list(spec.groups), SEED,
                                         neuron_model=spec.neuron_model,
                                         device=dev)
        engine.run(init(), g, table, cfg, WARM, device=dev)
        st = init()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fin, spikes = engine.run(st, g, table, cfg, STEPS, device=dev)
        wall = time.perf_counter() - t0
        sha = hashlib.sha256(spikes.cpu().numpy().tobytes()).hexdigest()

        # the same run again under the profiler: device time by kernel
        st = init()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            engine.run(st, g, table, cfg, STEPS, device=dev)
            pwall = time.perf_counter() - t1
        busy, launches, by_name = 0.0, 0, {}
        for ev in prof.key_averages():
            if str(ev.device_type).endswith("CUDA"):
                ms = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0)) / 1e3
                busy += ms
                launches += ev.count
                key = ev.key.replace("(anonymous namespace)::", "")[:50]
                by_name[key] = by_name.get(key, 0.0) + ms / STEPS
        top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6])
        print(json.dumps({
            "root": root, "network": name, "steps": STEPS,
            "steps_per_s": STEPS / wall, "spikes": int(spikes.sum()),
            "spikes_sha256": sha,
            "device_ms_per_step": busy / STEPS,
            "launches_per_step": launches / STEPS,
            "device_idle_share_profiled": 1 - busy / (pwall * 1e3),
            "ms_per_step_by_kernel": top,
            "card": torch.cuda.get_device_name(0)}), flush=True)
        del g, table, fin, spikes, st, prof


def main(roots: list[str]) -> None:
    if not roots:
        sys.exit(__doc__)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for root in roots:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             os.path.abspath(root)], capture_output=True, text=True,
            timeout=900)
        sys.stderr.write(res.stderr[-4000:])
        if res.returncode != 0:
            sys.exit(f"{root}: exit {res.returncode}")
        for line in res.stdout.splitlines():
            if line.startswith("{"):
                print(json.dumps({**json.loads(line), "power": smi}),
                      flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2])
    else:
        main(sys.argv[1:])
