"""End-to-end LM training driver: a ~45M-parameter model, a few hundred
steps, on the card.

The port of ``examples/train_lm.py``: the full production loop -
deterministic resumable pipeline, AdamW + clipping + gradient
accumulation over microbatches, async checkpoints every 25 steps,
``--resume`` from the newest readable one, a loss report.  (A ~100M+
model trains identically: pass --d-model 768 --layers 12.)

    python -m repro_torch.examples.train_lm --steps 60
    python -m repro_torch.examples.train_lm --steps 60 --resume

Modules: ``configs/base.py`` (the dense ``ModelConfig``),
``models/model.py::build_model``, ``data/pipeline.py``,
``train/loop.py`` (``make_train_step``), ``train/optimizer.py``,
``checkpoint/manager.py``.  A step with gradients never reaches K8: the
train route's attention is torch ops.  Since batch ``i`` is a pure
function of ``i``, a resumed run repeats the uninterrupted one (bitwise
on the card under ``torch.use_deterministic_algorithms(True)``).
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.examples import add_device
from repro_torch.models.model import build_model
from repro_torch.train.loop import make_train_step, param_tree
from repro_torch.train.optimizer import init_opt_state

__all__ = ["build_parser", "model_config", "main"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--d-model", type=int, default=384)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--ckpt", default="/tmp/lm_ckpt")
    ap.add_argument("--resume", action="store_true")
    add_device(ap)
    return ap


def model_config(args) -> ModelConfig:
    """The script's dense model of ``--d-model`` x ``--layers``."""
    return ModelConfig(
        name=f"lm-{args.d_model}d{args.layers}L", family="dense",
        n_layers=args.layers, d_model=args.d_model,
        n_heads=args.d_model // 64, n_kv_heads=max(args.d_model // 128, 1),
        d_ff=args.d_model * 4, vocab_size=args.vocab, dtype="float32",
        tie_embeddings=True)


def main(argv=None, params=None) -> dict:
    """``params`` (a module of ``build_model(model_config(args))``'s kind)
    replaces the seed-0 init.  Returns the losses and gradient norms of
    the steps run, and the final module and optimizer state."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = model_config(args)
    m = build_model(cfg)
    total, _ = cfg.param_count()
    print(f"model {cfg.name}: ~{total/1e6:.1f}M params")

    tcfg = TrainConfig(optimizer="adamw", lr=1e-3, weight_decay=0.01)
    if params is None:
        params = m.init(0, device=dev, dtype=torch.float32)
    opt = init_opt_state(tcfg, param_tree(params))
    pipe = TokenPipeline(vocab_size=args.vocab, seq_len=args.seq,
                         global_batch=args.batch, seed=17)
    mgr = CheckpointManager(args.ckpt, keep=2)
    start = 0
    if args.resume and mgr.latest_step() is not None:
        (tree, opt), meta = mgr.restore((param_tree(params), opt))
        with torch.no_grad():
            for name, p in params.named_parameters():
                p.copy_(tree[name])
        start = meta["step"]
        print(f"resumed from step {start}")

    step_fn = make_train_step(m, tcfg, microbatches=args.microbatches)
    losses, gnorms = [], []
    t0 = time.time()
    for i in range(start, args.steps):
        batch = {"tokens": torch.as_tensor(pipe.batch(i)["tokens"],
                                           device=dev)}
        params, opt, met = step_fn(params, opt, batch, i)
        losses.append(met["loss"].detach())      # read once, at the end
        gnorms.append(met["grad_norm"].detach())
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={float(met['loss']):.4f} "
                  f"gnorm={float(met['grad_norm']):.3f} "
                  f"({(time.time()-t0)/(i-start+1):.2f}s/step)")
        if (i + 1) % 25 == 0:
            mgr.save(i + 1, (param_tree(params), opt), blocking=False,
                     metadata={"step": i + 1})
    mgr.wait()
    wall = time.time() - t0
    print("ok")
    return {"name": cfg.name, "params_count": total, "start": start,
            "losses": [float(x) for x in losses],
            "grad_norms": [float(x) for x in gnorms], "wall_s": wall,
            "params": params, "opt_state": opt}


if __name__ == "__main__":
    main(sys.argv[1:])
