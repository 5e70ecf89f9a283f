"""Quickstart: the two faces of the framework in about a minute, on the
card.

The port of ``examples/quickstart.py``:

1. CORTEX SNN engine - build the balanced random network (paper §IV.A),
   simulate 200 ms with pl-STDP, print the firing-rate band.
2. LM stack - three AdamW steps of a reduced qwen2.5 config on the
   deterministic synthetic pipeline.

    python -m repro_torch.examples.quickstart [--device cuda]

Modules: ``core/models.py``, ``core/builder.py``, ``core/snn.py``,
``core/engine.py`` (``engine.run`` on the ``"cuda"`` backend: K1 with the
LIF step as its epilogue, then K3, once a step); ``configs``,
``models/model.py::build_model``, ``data/pipeline.py``,
``train/loop.py``, ``train/optimizer.py``.
"""

from __future__ import annotations

import argparse
import sys

import torch

from repro_torch import configs
from repro_torch.configs.base import TrainConfig
from repro_torch.core import builder, engine, models, snn
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.examples import add_device
from repro_torch.models.model import build_model
from repro_torch.train.loop import make_train_step, param_tree
from repro_torch.train.optimizer import init_opt_state

__all__ = ["build_parser", "snn_demo", "lm_demo", "main"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device(ap)
    return ap


def snn_demo(device="cuda") -> dict:
    dev = resolve_device(device)
    print("== CORTEX SNN: balanced random network (hpc_benchmark) ==")
    spec, stdp = models.hpc_benchmark(scale=0.04, stdp=True)
    dec = builder.decompose(spec, 1)
    g = builder.build_shards(spec, dec)[0].to(dev)
    table = snn.make_param_table(list(spec.groups), dt=models.DT_MS,
                                 device=dev)
    cfg = engine.EngineConfig(dt=models.DT_MS, stdp=stdp)
    state = engine.init_state(g, list(spec.groups), 0, device=dev)
    state, spikes = engine.run(state, g, table, cfg, 2000, device=dev)
    rate = models.firing_rate_hz(spikes, spec.n_neurons)
    print(f"  neurons={spec.n_neurons} edges={g.n_edges} "
          f"steps=2000 (200 ms)")
    print(f"  mean rate = {rate:.2f} Hz (paper band: < 10 Hz, "
          f"asynchronous-irregular)")
    w = state.weights
    print(f"  STDP weights: min={float(w.min()):.1f} "
          f"max={float(w.max()):.1f} (bounded)")
    plastic = g.plastic & (g.delay > 0)
    return {"neurons": spec.n_neurons, "edges": g.n_edges, "steps": 2000,
            "rate_hz": rate, "w_min": float(w.min()),
            "w_max": float(w.max()),
            "plastic_w_min": float(w[plastic].min()),
            "plastic_w_max": float(w[plastic].max()),
            "w_bounds": [stdp.w_min, stdp.w_max],
            "finite": bool(torch.isfinite(state.neurons.v_m).all())}


def lm_demo(device="cuda", params=None) -> dict:
    """Three AdamW steps of qwen2.5-3b's smoke config; ``params`` (a
    module of ``build_model(cfg)``'s kind) replaces the seed-0 init."""
    dev = resolve_device(device)
    print("== LM stack: one train step (reduced qwen2.5) ==")
    cfg = configs.get_smoke("qwen2.5-3b")
    m = build_model(cfg)
    if params is None:
        params = m.init(0, device=dev)
    tcfg = TrainConfig(optimizer="adamw", lr=1e-3)
    opt = init_opt_state(tcfg, param_tree(params))
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=32,
                         global_batch=4)
    step = make_train_step(m, tcfg)
    losses, gnorms = [], []
    for i in range(3):
        batch = {"tokens": torch.as_tensor(pipe.batch(i)["tokens"],
                                           device=dev)}
        params, opt, met = step(params, opt, batch, i)
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
        print(f"  step {i}: loss={losses[-1]:.3f} "
              f"grad_norm={gnorms[-1]:.3f}")
    return {"losses": losses, "grad_norms": gnorms}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    rec = {"snn": snn_demo(args.device), "lm": lm_demo(args.device)}
    print("ok")
    return rec


if __name__ == "__main__":
    main(sys.argv[1:])
