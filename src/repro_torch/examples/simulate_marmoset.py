"""End-to-end driver for the paper's evaluation case (§IV.B), on the card.

The port of ``examples/simulate_marmoset.py``: builds the multi-area
marmoset-style cortical network, decomposes it with Area-Processes
Mapping + Multisection Division onto a (rows x width) layout, runs a few
hundred ms of biological time with checkpoint/restart, and reports the
mean rate and the spike-exchange traffic split (local vs remote) that the
indegree decomposition buys.

    python -m repro_torch.examples.simulate_marmoset \\
        [--scale 0.002] [--areas 4] [--steps 2000] [--ckpt /tmp/marmoset]
    python -m repro_torch.examples.simulate_marmoset --grid 2x2 \\
        --spike-wire sparse

With ``--grid ROWSxWIDTH`` above 1x1 the shards of that mesh are stepped
together on the one device by the distributed engine (the script's
multi-device branch), and the wire-bytes table and split are printed.

Modules: ``core/models.py::marmoset``, ``core/builder.py``
(``decompose(spec, 1, method="random")``, ``build_shards``),
``core/engine.py``, ``core/distributed.py`` (``mesh_decompose``,
``prepare_stacked``, ``init_stacked_state``, ``make_distributed_step``,
``wire_bytes_per_step``, ``wire_bytes_split``), ``core/wire.py``,
``checkpoint/manager.py`` (saves every ``--save-every`` steps,
asynchronously, flat-layout weights; a final ``restore``).  On
``"cuda"`` a step launches K1 with the LIF step as its epilogue, once a
shard.
"""

from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import backends, builder, engine, models, snn
from repro_torch.core import distributed as dist
from repro_torch.core.device import resolve_device
from repro_torch.examples import add_device, add_grid

__all__ = ["build_parser", "main"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=0.002)
    ap.add_argument("--areas", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--ckpt", default="/tmp/marmoset_ckpt")
    ap.add_argument("--save-every", type=int, default=500)
    ap.add_argument("--spike-wire", default="packed",
                    help="spike-exchange codec: f32|u8|packed|sparse|"
                         "sparse:<rate> (--grid above 1x1 only)")
    ap.add_argument("--spike-wire-remote", default=None,
                    help="codec for the cross-row boundary tier (the "
                         "inter-host hop on a host-aligned mesh); "
                         "default: same as --spike-wire")
    add_device(ap)
    add_grid(ap)
    return ap


def _run_grid(spec, table, args, mgr, dev) -> dict:
    rows, width = args.grid
    dec = dist.mesh_decompose(spec, rows, width)
    net = dist.prepare_stacked(spec, dec, rows, width).to(dev)
    dcfg = dist.DistributedConfig(
        engine=engine.EngineConfig(dt=models.DT_MS),
        spike_wire=args.spike_wire,
        spike_wire_remote=args.spike_wire_remote)
    step = dist.make_distributed_step(net, table, dcfg, device=dev)
    state = dist.init_stacked_state(net, list(spec.groups), 0, device=dev)
    print(f"  mesh {rows}x{width}; spike traffic/step/shard: "
          f"area={net.comm_bytes_area}B vs "
          f"global={net.comm_bytes_global}B")
    # what each wire codec would ship per step on THIS decomposition
    # (the sparse ID wire wins below the packed crossover firing rate)
    table_b = {w: dist.wire_bytes_per_step(net, "area", w)
               for w in ("f32", "u8", "packed", "sparse")}
    split = dist.wire_bytes_split(
        "area", args.spike_wire, args.spike_wire_remote,
        n_shards=net.n_shards, row_width=net.row_width,
        n_local=net.n_local, b_pad=net.b_pad)
    run_tag = args.spike_wire + (
        f"+{args.spike_wire_remote}" if args.spike_wire_remote else "")
    print("  wire bytes/step (area): "
          + "  ".join(f"{w}={b}B" for w, b in table_b.items())
          + f"  [running: {run_tag}: intra-host {split['intra']}B + "
          + f"inter-host {split['inter']}B]")
    carry = step.carry_from(state)
    out = torch.empty((net.n_shards, net.n_local), dtype=torch.bool,
                      device=dev)
    counts = torch.zeros(out.shape, dtype=torch.int32, device=dev)
    for i in range(args.steps):
        step.advance(carry, out=out)
        counts += out
        if i % args.save_every == args.save_every - 1:
            mgr.save(i + 1, step.state_from(carry, state, "flat"),
                     blocking=False)
    state = step.state_from(carry, state, "flat")
    mgr.wait()
    overflow = int(state.wire_overflow.sum())
    if overflow:
        print(f"  WARNING: lossy wire saturated {overflow} time(s) - "
              f"raise the sparse capacity (e.g. sparse:<rate>)")
    return {"state": state, "spikes": int(counts.sum()),
            "wire_overflow": overflow, "wire_bytes_per_step": table_b,
            "split": split, "comm_bytes_area": net.comm_bytes_area,
            "comm_bytes_global": net.comm_bytes_global}


def _run_single(spec, table, args, mgr, dev) -> dict:
    dec = builder.decompose(spec, 1, method="random")
    g = builder.build_shards(spec, dec)[0].to(dev)
    cfg = engine.EngineConfig(dt=models.DT_MS)
    ctx = engine.make_step_context(g, table, cfg)
    state = ctx.init_state(list(spec.groups), 0)
    backend = backends.get_backend(cfg.sweep)
    counts = torch.zeros(g.n_local, dtype=torch.int32, device=dev)

    def flat(st):
        return engine.state_with_weights_layout(st, g, "flat",
                                                backend=backend)

    for i in range(args.steps):
        state, bits = ctx.step(state)
        counts += bits
        if i % args.save_every == args.save_every - 1:
            mgr.save(i + 1, flat(state), blocking=False,
                     metadata={"step": i + 1})
            print(f"  step {i+1}: checkpoint saved")
    mgr.wait()
    return {"state": flat(state), "spikes": int(counts.sum())}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    spec = models.marmoset(scale=args.scale, n_areas=args.areas)
    table = snn.make_param_table(list(spec.groups), dt=models.DT_MS,
                                 device=dev)
    mgr = CheckpointManager(args.ckpt, keep=2)
    rows, width = args.grid
    print(f"marmoset: {spec.n_neurons} neurons, {args.areas} areas, "
          f"{rows * width} shard(s) on {dev}")
    run = _run_single if (rows, width) == (1, 1) else _run_grid
    rec = run(spec, table, args, mgr, dev)
    rate = rec["spikes"] / (spec.n_neurons * args.steps * models.DT_MS
                            * 1e-3)
    print(f"  simulated {args.steps * models.DT_MS:.0f} ms, "
          f"mean rate = {rate:.2f} Hz")
    # restart proof: restore the latest checkpoint
    last = mgr.latest_step()
    restored = meta = None
    if last:
        restored, meta = mgr.restore(rec["state"])
        print(f"  restored checkpoint @ step {last} ok")
    print("ok")
    return dict(rec, neurons=spec.n_neurons, steps=args.steps,
                grid=[rows, width], device=str(dev), mean_hz=rate,
                last_step=last,
                restored=restored, metadata=meta)


if __name__ == "__main__":
    main(sys.argv[1:])
