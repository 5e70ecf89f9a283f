"""Batched serving example: wave admission + greedy decode over KV caches,
on the card.

The port of ``examples/serve_lm.py``.

    python -m repro_torch.examples.serve_lm [--arch qwen2.5-3b]

Modules: ``configs`` (the arch's smoke config), ``models/model.py::
build_model``, ``serve/engine.py::BatchServer``.  On the card the
prefill's causal attention is K8 (``kernels/flash_attention.py``; the
smoke configs are fp32, so its ``simt`` route), once a layer; decode runs
torch ops.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch import configs
from repro_torch.core.device import resolve_device
from repro_torch.examples import add_device
from repro_torch.models.model import build_model
from repro_torch.serve.engine import BatchServer

__all__ = ["build_parser", "main", "REQUESTS"]

REQUESTS = (
    [11, 23, 5, 42],
    [7, 7, 7],
    [101, 55, 2, 9, 13, 28],
    [64],
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--max-new", type=int, default=24)
    add_device(ap)
    return ap


def main(argv=None, params=None) -> dict:
    """``params`` (a module of ``build_model(cfg)``'s kind) replaces the
    seed-0 init."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch)
    m = build_model(cfg)
    if params is None:
        params = m.init(0, device=dev)
    server = BatchServer(m, params, slots=4, max_len=128, eos_id=-1,
                         device=dev)

    requests = [list(r) for r in REQUESTS]
    outs, stats = server.serve(requests, max_new_tokens=args.max_new)
    for i, o in enumerate(outs):
        print(f"req{i}: prompt={requests[i]} -> {o[:12]}...")
    print(f"prefill {stats.prefill_s*1e3:.1f} ms, "
          f"decode {stats.decode_tok_per_s:.1f} tok/s "
          f"({stats.tokens_out} tokens)")
    print("ok")
    return {"arch": args.arch, "outputs": outs,
            "prefill_s": stats.prefill_s,
            "decode_tok_per_s": stats.decode_tok_per_s,
            "tokens_out": stats.tokens_out}


if __name__ == "__main__":
    main(sys.argv[1:])
