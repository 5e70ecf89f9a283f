"""Where a fresh process's first rwkv6-3b train step spends its time:
``chip_smoke.py``'s leg (i) in one process (rwkv6-3b at published width,
1 layer, fp32, B 2 x S 32, AdamW at the leg's lr), its first step and a
second one, each split into the loss's value and gradient
(``loop._value_and_grad``) and the rest of the step, the first under
``torch.profiler`` (host and device time by op, the 15 largest by host
time).

    python3 scripts/headcut_step_probe.py

Prints one JSON line and writes it to
``build/headcut_step_probe.json``.  Needs a CUDA device; imports no
JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as c  # noqa: E402
from repro_torch.train import loop  # noqa: E402


def timed_step(m, step, params, opt, batch, i):
    """One step: the value and gradient alone first (thrown away), then
    the whole step; their seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop._value_and_grad(m, params, batch)
    torch.cuda.synchronize()
    vg = time.perf_counter() - t0
    t0 = time.perf_counter()
    params, opt, met = step(params, opt, batch, i)
    float(met["loss"])
    torch.cuda.synchronize()
    return params, opt, {"value_and_grad_s": vg,
                         "step_s": time.perf_counter() - t0}


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    spec = c.LM_MESH_HEADCUT
    cfg = c._headcut_cfg()
    m = c.build_model(cfg)
    t0 = time.perf_counter()
    params = m.init(c.SEED, device=c.DEV, dtype=torch.float32)
    torch.cuda.synchronize()
    rec = {"device": smi, "init_s": time.perf_counter() - t0}
    tcfg = c.TrainConfig(lr=spec["lr"])
    opt = c.train_opt.init_opt_state(tcfg, params)
    step = c.train_loop.make_train_step(m, tcfg)
    pipe = c.TokenPipeline(vocab_size=cfg.vocab_size, seq_len=spec["seq"],
                           global_batch=spec["batch"], seed=c.SEED)
    batch = {"tokens": torch.as_tensor(pipe.batch(0)["tokens"],
                                       device=c.DEV)}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        params, opt, rec["first"] = timed_step(m, step, params, opt, batch,
                                               0)
    params, opt, rec["second"] = timed_step(m, step, params, opt, batch, 1)
    rows = sorted(prof.key_averages(), key=lambda e: -e.cpu_time_total)
    rec["first_top_ops"] = [
        {"op": e.key, "calls": e.count,
         "host_ms": e.cpu_time_total / 1e3,
         "self_host_ms": e.self_cpu_time_total / 1e3,
         "device_ms": getattr(e, "device_time_total",
                              getattr(e, "cuda_time_total", 0)) / 1e3}
        for e in rows[:15]]
    print(json.dumps(rec), flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "headcut_step_probe.json"),
              "w") as f:
        json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
