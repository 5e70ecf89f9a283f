"""Run any scenario-zoo network x neuron model end-to-end, on the card.

The port of ``examples/run_scenario.py``: pick a scenario (``brunel`` with
its (g, eta) regime knobs, the Potjans-Diesmann ``microcircuit``,
``hpc_benchmark``, ``marmoset``) or a NeuronModel demo network
(``--model izhikevich`` / ``adex`` / ``poisson``), simulate, and report
per-population rates.

    python -m repro_torch.examples.run_scenario --scenario brunel \\
        --scale 0.02 --g 4.5 --eta 2.0 --steps 2000
    python -m repro_torch.examples.run_scenario --scenario microcircuit \\
        --scale 0.02 --steps 1000
    python -m repro_torch.examples.run_scenario --model izhikevich
    python -m repro_torch.examples.run_scenario --grid 2x2

With ``--grid ROWSxWIDTH`` above 1x1 the same run goes through the
distributed engine's stacked step on the one device (the script's
multi-device branch): every scenario and model rides the same
decomposition, backends and spike wires.

Modules: ``core/models.py`` (the scenario), ``core/neuron_models.py``
(the parameter table), ``core/builder.py`` (decomposition and shard),
``core/engine.py`` (``init_state``, the step), ``core/backends.py``
(``--sweep``), ``core/distributed.py`` (``--grid``: ``mesh_decompose``,
``prepare_stacked``, ``init_stacked_state``, ``make_distributed_step``).
On ``"cuda"`` a step launches K1 with the neuron step as its epilogue
(K2 for LIF, K4 Izhikevich, K5 AdEx), K1 then K2 for the ``lif+poisson``
composite, and K3 where the network has STDP.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.core import builder, engine, models, neuron_models
from repro_torch.core import distributed as dist
from repro_torch.core.device import resolve_device
from repro_torch.examples import WINDOW_STEPS, add_device, add_grid

__all__ = ["build_parser", "main", "network"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenario", default="brunel",
                    choices=models.available_scenarios())
    ap.add_argument("--model", default=None,
                    help="run the cross-model demo network for this "
                         "NeuronModel instead of --scenario "
                         f"(one of {neuron_models.available_models()})")
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--g", type=float, default=None,
                    help="brunel inhibition balance")
    ap.add_argument("--eta", type=float, default=None,
                    help="brunel external drive / threshold rate")
    ap.add_argument("--poisson-input", action="store_true",
                    help="brunel: explicit Poisson emitter population "
                         "(the lif+poisson composite) instead of the "
                         "collapsed per-neuron rate")
    ap.add_argument("--sweep", default="cuda",
                    help="execution backend (cuda|cuda:sparse|cuda:auto|"
                         "flat|bucketed)")
    ap.add_argument("--spike-wire", default="packed")
    add_device(ap)
    add_grid(ap)
    return ap


def network(args):
    """``(spec, stdp, tag)`` of the parsed flags, as the script builds
    them."""
    if args.model:
        spec, stdp = models.model_demo(args.model, scale=args.scale)
        return spec, stdp, f"model_demo({args.model})"
    kw = {}
    if args.scenario == "brunel":
        if args.g is not None:
            kw["g"] = args.g
        if args.eta is not None:
            kw["eta"] = args.eta
        if args.poisson_input:
            kw["poisson_input"] = True
    spec, stdp = models.get_scenario(args.scenario, scale=args.scale, **kw)
    return spec, stdp, args.scenario


def _run_single(spec, stdp, table, args, dev):
    """Cumulative per-neuron counts at every window's end, (W, n)."""
    g = builder.build_shards(spec, builder.decompose(spec, 1))[0].to(dev)
    cfg = engine.EngineConfig(dt=models.DT_MS, stdp=stdp, sweep=args.sweep,
                              neuron_model=spec.neuron_model)
    state = engine.init_state(g, list(spec.groups), 0, sweep=args.sweep,
                              neuron_model=spec.neuron_model, device=dev)
    step = engine.make_step_fn(g, table, cfg)
    counts = torch.zeros(g.n_local, dtype=torch.int32, device=dev)
    snaps = []
    for i in range(args.steps):
        state, bits = step(state)
        counts += bits
        if (i + 1) % WINDOW_STEPS == 0 or i + 1 == args.steps:
            snaps.append(counts.clone())
    return torch.stack(snaps)[:, :spec.n_neurons]


def _run_grid(spec, stdp, table, args, dev):
    rows, width = args.grid
    dec = dist.mesh_decompose(spec, rows, width)
    net = dist.prepare_stacked(spec, dec, rows, width).to(dev)
    dcfg = dist.DistributedConfig(
        engine=engine.EngineConfig(dt=models.DT_MS, stdp=stdp,
                                   sweep=args.sweep,
                                   neuron_model=spec.neuron_model),
        spike_wire=args.spike_wire)
    step = dist.make_distributed_step(net, table, dcfg, device=dev)
    state = dist.init_stacked_state(net, list(spec.groups), 0,
                                    sweep=args.sweep,
                                    neuron_model=spec.neuron_model,
                                    device=dev)
    carry = step.carry_from(state)
    out = torch.empty((net.n_shards, net.n_local), dtype=torch.bool,
                      device=dev)
    counts = torch.zeros(out.shape, dtype=torch.int32, device=dev)
    snaps = []
    for i in range(args.steps):
        step.advance(carry, out=out)
        counts += out
        if (i + 1) % WINDOW_STEPS == 0 or i + 1 == args.steps:
            snaps.append(counts.clone())
    # shard rows -> global ids (padding slots carry global id -1)
    gid = net.graph["global_id"].reshape(-1).long()
    live = gid >= 0
    by_shard = torch.stack(snaps).reshape(len(snaps), -1)
    glob = torch.zeros((len(snaps), spec.n_neurons), dtype=torch.int32,
                       device=dev)
    glob[:, gid[live]] = by_shard[:, live]
    return glob


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    spec, stdp, tag = network(args)
    model = neuron_models.get_model(spec.neuron_model)
    table = model.make_param_table(list(spec.groups), dt=models.DT_MS,
                                   device=dev)
    rows, width = args.grid
    print(f"{tag}: {spec.n_neurons} neurons, "
          f"{len(spec.populations)} population(s), "
          f"neuron_model={spec.neuron_model}, {rows * width} shard(s) on "
          f"{dev}")

    t0 = time.perf_counter()
    run = _run_single if (rows, width) == (1, 1) else _run_grid
    cum = run(spec, stdp, table, args, dev).cpu().numpy()   # the one read
    wall = time.perf_counter() - t0
    counts = cum[-1].astype(np.float64)

    t_s = args.steps * models.DT_MS * 1e-3
    off = spec.pop_offsets()
    pops = {}
    # spike counts and lengths of the windows (the last one may be short)
    win = np.diff(cum, axis=0, prepend=0)
    win_s = np.diff([0] + [min((j + 1) * WINDOW_STEPS, args.steps)
                           for j in range(len(cum))]) * models.DT_MS * 1e-3
    for i, p in enumerate(spec.populations):
        r = counts[off[i]:off[i + 1]].sum() / (p.n * t_s)
        print(f"  {p.name:6s} n={p.n:7d} rate={r:8.2f} Hz")
        w = win[:, off[i]:off[i + 1]].sum(axis=1)
        pops[p.name] = {
            "n": p.n, "rate_hz": float(r),
            "spikes": int(counts[off[i]:off[i + 1]].sum()),
            "per_window_hz": (w / (p.n * win_s)).tolist()}
    total = counts.sum()
    mean = total / (spec.n_neurons * t_s)
    print(f"  total: {total:.0f} spikes over "
          f"{args.steps * models.DT_MS:.0f} ms "
          f"(mean {mean:.2f} Hz)")
    print("ok")
    return {"tag": tag, "neurons": spec.n_neurons,
            "neuron_model": spec.neuron_model, "steps": args.steps,
            "sweep": args.sweep, "grid": [rows, width], "device": str(dev),
            "populations": pops, "total_spikes": int(total),
            "mean_hz": float(mean), "window_steps": WINDOW_STEPS,
            "wall_s": wall, "counts": cum[-1]}


if __name__ == "__main__":
    main(sys.argv[1:])
