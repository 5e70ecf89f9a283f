"""Training launcher of the LM face.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        [--smoke | --full] [--steps 20] [--seq 32] [--batch 4] \\
        [--microbatches 1] [--lr 1e-3] [--optimizer adamw] \\
        [--mesh 2x2] [--ckpt DIR] [--resume] [--save-every 10] \\
        [--device cuda] [--record FILE]

The port of the reference package's ``launch/train.py``: the arch's smoke
config (``--smoke``, the default) or its published one (``--full``) is
built with fp32 parameters (``TrainConfig.param_dtype``) drawn from seed
0, and trained on ``TokenPipeline`` batches (seed 0), one optimizer step
per batch.  With ``--ckpt`` the ``(params, optimizer state)`` pair is
saved every ``--save-every`` steps (asynchronously) and ``--resume``
restarts from the newest readable checkpoint; since batch ``i`` is a pure
function of ``i``, a resumed run repeats the uninterrupted one.  Each
step's duration goes to a ``HeartbeatMonitor``, which reports
stragglers at the end.

Runs on the card unless ``--device cpu`` is given.  The stub inputs of
the modality archs (whisper's ``frames``, internvl2's ``patches``) are
drawn as ``N(0, 0.02^2)`` from a ``torch.Generator`` on the device seeded
with the step, where the reference draws them with ``jax.random.key(step)``:
the same distribution, other numbers.

``--mesh DxM`` (``"2x2"``; one dim is ``("data",)``, two ``("data",
"model")``, three ``("pod", "data", "model")``, as the reference parses
it) trains on a process mesh: the command starts ``prod(dims)`` copies
of itself, joined through ``core/multihost.initialize`` by the
environment it reads (``REPRO_COORD_ADDR``, ``REPRO_NUM_PROC``,
``REPRO_PROC_ID``; gloo on the CPU or where the processes share a card,
nccl where each has its own), and waits for them; a copy started with
that environment is one of them.  Each process draws the single-device
model's parameters and keeps its blocks (``rules.local_specs``: for
every arch, decoder-only or the encoder-decoder, the reference's
``param_specs``, FSDP over ``data`` and tensor parallelism over
``model``), cuts each global batch (the tokens, and whisper's
``frames`` with them) over ``pod x data`` (``rules.batch_spec``;
microbatch by microbatch, as the reference's microbatches are cut) and
trains under ``rules.use_mesh`` (``train/loop.py``).  A checkpoint holds
the global leaves (gathered, and written by process 0); ``--resume``
cuts them for whatever mesh it is given - the elastic restart, which
reshards the ``data`` and ``model`` cuts as well as the experts.  ``--record FILE`` has process 0 write
``{"start", "losses", "grad_norms", "step_s"}`` there.

``main(argv)`` returns ``{"start", "losses", "grad_norms", "step_s",
"params", "opt_state"}`` for callers in the same process; the launching
process of a mesh run returns process 0's record.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

import torch

from repro_torch import configs, convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import TrainConfig
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.mesh import join_process_mesh, parse_mesh
from repro_torch.launch.multihost import _free_port
from repro_torch.models.model import build_model
from repro_torch.runtime.fault import HeartbeatMonitor
from repro_torch.sharding import rules
from repro_torch.train.loop import make_train_step, param_tree
from repro_torch.train.optimizer import init_opt_state, torch_dtype

__all__ = ["main", "parse_args", "make_batch", "batch_block"]

#: seconds the launching process of a mesh run waits for its processes
MESH_TIMEOUT_S = 1800.0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=configs.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--record", default=None)
    return ap.parse_args(argv)


def make_batch(cfg, pipe: TokenPipeline, step: int, device) -> dict:
    """Batch ``step``: the pipeline's tokens on ``device``, and the
    modality stub's inputs drawn from a generator seeded with ``step``."""
    b = {"tokens": torch.as_tensor(pipe.batch(step)["tokens"],
                                   device=device)}
    stub = {"audio": ("frames", cfg.encoder_seq),
            "vlm": ("patches", cfg.n_prefix_embeds)}.get(cfg.family)
    if stub is not None:
        gen = torch.Generator(device=device).manual_seed(step)
        name, n = stub
        b[name] = torch.randn((pipe.global_batch, n, cfg.d_model),
                              generator=gen, device=device) * 0.02
    return b


def batch_block(a: torch.Tensor, mesh, microbatches: int = 1):
    """This process's rows of a global batch array: the batch split over
    ``rules.batch_spec(mesh)``'s axes within each of the ``microbatches``
    (the reference's microbatch ``i`` is global rows ``i * B / mb`` on,
    each cut over the batch axes), in microbatch order."""
    spec = rules.batch_spec(mesh)
    axes = rules._axes(spec[0]) if len(spec) else ()
    n = mesh.axis_size(axes)
    b = a.shape[0]
    if b % (microbatches * n):
        raise ValueError(f"a batch of {b} does not split into "
                         f"{microbatches} microbatches over {n} blocks")
    rows = b // (microbatches * n)
    k = mesh.axis_index(axes)
    blocks = a.reshape(microbatches, n, rows, *a.shape[1:])[:, k]
    return blocks.reshape(microbatches * rows, *a.shape[1:])


def _launch_mesh(argv, size: int, args) -> dict:
    """Start ``size`` copies of this command as one process mesh; wait
    for all of them (one that fails fails the launch at once)."""
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                       ".."))
    env = dict(os.environ, REPRO_COORD_ADDR=f"127.0.0.1:{_free_port()}",
               REPRO_NUM_PROC=str(size), LOCAL_WORLD_SIZE=str(size),
               PYTHONPATH=os.pathsep.join(
                   p for p in (src, os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *argv],
        env=dict(env, REPRO_PROC_ID=str(r))) for r in range(size)]
    deadline = time.monotonic() + MESH_TIMEOUT_S
    failed = []
    try:
        while procs and time.monotonic() < deadline:
            rcs = [p.poll() for p in procs]
            failed = [(r, rc) for r, rc in enumerate(rcs)
                      if rc not in (None, 0)]
            if failed or all(rc == 0 for rc in rcs):
                break
            time.sleep(0.1)
        else:
            failed = [("timeout", MESH_TIMEOUT_S)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if failed:
        raise SystemExit(f"mesh processes failed: {failed}")
    if args.record:
        with open(args.record) as f:
            return json.load(f)
    return {}


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    mesh_dims = parse_mesh(args.mesh)
    size = 1
    if mesh_dims is not None:
        size = math.prod(mesh_dims[0])
        if size > 1 and "REPRO_PROC_ID" not in os.environ:
            return _launch_mesh(argv, size, args)
    device = resolve_device(args.device)
    mesh = None
    if mesh_dims is not None:
        mesh = join_process_mesh(*mesh_dims, device=device)
        if device.type == "cuda" and torch.cuda.device_count() >= size:
            device = torch.device("cuda", mesh.rank)     # a card each
    rank0 = mesh is None or mesh.rank == 0
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    m = build_model(cfg)
    tcfg = TrainConfig(optimizer=args.optimizer, lr=args.lr)

    params = m.init(0, device=device, dtype=torch_dtype(tcfg.param_dtype),
                    mesh=mesh)
    opt = init_opt_state(tcfg, params)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch, seed=0)
    mgr = CheckpointManager(args.ckpt, keep=2) if args.ckpt else None
    monitor = HeartbeatMonitor(1)
    n_exp = cfg.moe.n_experts if getattr(cfg, "moe", None) else 0

    start = 0
    if mgr and args.resume and mgr.latest_step() is not None:
        target = (param_tree(params), opt)
        shardings = None
        if mesh is not None:
            shardings = rules.tree_map_with_path(
                lambda _, sp: rules.NamedSharding(mesh, sp),
                rules.local_specs(mesh, target, n_exp))
        (tree, opt), meta = mgr.restore(target, shardings=shardings)
        with torch.no_grad():
            for name, p in params.named_parameters():
                p.copy_(tree[name])
        start = meta["step"]
        if rank0:
            print(f"resumed @ {start}")

    step_fn = make_train_step(m, tcfg, microbatches=args.microbatches)
    losses, gnorms, step_s = [], [], []
    with (rules.use_mesh(mesh) if mesh is not None
          else contextlib.nullcontext()):
        for i in range(start, args.steps):
            t0 = time.monotonic()
            batch = make_batch(cfg, pipe, i, device)
            if mesh is not None:
                batch = {k: batch_block(v, mesh, args.microbatches)
                         for k, v in batch.items()}
            params, opt, met = step_fn(params, opt, batch, i)
            losses.append(float(met["loss"]))     # waits for the step
            gnorms.append(float(met["grad_norm"]))
            step_s.append(time.monotonic() - t0)
            monitor.observe(0, step_s[-1])
            if rank0 and (i % 5 == 0 or i == args.steps - 1):
                print(f"step {i:4d} loss={losses[-1]:.4f} "
                      f"gnorm={gnorms[-1]:.3f}", flush=True)
            if mgr and (i + 1) % args.save_every == 0:
                state = (param_tree(params), opt)
                if mesh is not None:       # every process gathers
                    state = convert.mesh_global(state, mesh, n_exp, 0)
                if rank0:
                    mgr.save(i + 1, state, blocking=False,
                             metadata={"step": i + 1})
    if mgr:
        mgr.wait()
    if monitor.stragglers():
        print("stragglers detected:", monitor.stragglers())
    rec = {"start": start, "losses": losses, "grad_norms": gnorms,
           "step_s": step_s}
    if args.record and rank0:
        with open(args.record, "w") as f:
            json.dump(rec, f)
    if mesh is not None and mesh.size > 1:
        import torch.distributed as tdist
        tdist.barrier()
        tdist.destroy_process_group()
    if rank0:
        print("done", flush=True)
    return dict(rec, params=params, opt_state=opt)


if __name__ == "__main__":
    main()
