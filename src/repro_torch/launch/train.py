"""Training launcher of the LM face.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        [--smoke | --full] [--steps 20] [--seq 32] [--batch 4] \\
        [--microbatches 1] [--lr 1e-3] [--optimizer adamw] \\
        [--ckpt DIR] [--resume] [--save-every 10] [--device cuda]

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
the same distribution, other numbers.  ``--mesh`` (the reference's
production mesh) is not ported: it raises.

``main(argv)`` returns ``{"start", "losses", "grad_norms", "step_s",
"params", "opt_state"}`` for callers in the same process.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import TrainConfig
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models.model import build_model
from repro_torch.runtime.fault import HeartbeatMonitor
from repro_torch.train.loop import make_train_step, param_tree
from repro_torch.train.optimizer import init_opt_state, torch_dtype

__all__ = ["main", "parse_args", "make_batch"]


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


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            "--mesh: the port trains on one device; the reference's "
            "sharded train step is not ported yet (ROADMAP Queue 1 item 3)")
    device = resolve_device(args.device)
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    m = build_model(cfg)
    tcfg = TrainConfig(optimizer=args.optimizer, lr=args.lr)

    params = m.init(0, device=device, dtype=torch_dtype(tcfg.param_dtype))
    opt = init_opt_state(tcfg, param_tree(params))
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch, seed=0)
    mgr = CheckpointManager(args.ckpt, keep=2) if args.ckpt else None
    monitor = HeartbeatMonitor(1)

    start = 0
    if mgr and args.resume and mgr.latest_step() is not None:
        (tree, opt), meta = mgr.restore((param_tree(params), opt))
        with torch.no_grad():
            for name, p in params.named_parameters():
                p.copy_(tree[name])
        start = meta["step"]
        print(f"resumed @ {start}")

    step_fn = make_train_step(m, tcfg, microbatches=args.microbatches)
    losses, gnorms, step_s = [], [], []
    for i in range(start, args.steps):
        t0 = time.monotonic()
        params, opt, met = step_fn(params, opt,
                                   make_batch(cfg, pipe, i, device), i)
        losses.append(float(met["loss"]))     # waits for the step
        gnorms.append(float(met["grad_norm"]))
        step_s.append(time.monotonic() - t0)
        monitor.observe(0, step_s[-1])
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={losses[-1]:.4f} "
                  f"gnorm={gnorms[-1]:.3f}", flush=True)
        if mgr and (i + 1) % args.save_every == 0:
            mgr.save(i + 1, (param_tree(params), opt), blocking=False,
                     metadata={"step": i + 1})
    if mgr:
        mgr.wait()
    if monitor.stragglers():
        print("stragglers detected:", monitor.stragglers())
    print("done", flush=True)
    return {"start": start, "losses": losses, "grad_norms": gnorms,
            "step_s": step_s, "params": params, "opt_state": opt}


if __name__ == "__main__":
    main()
