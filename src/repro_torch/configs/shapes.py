"""Assigned input-shape set (LM-family): seq_len x global_batch.

``decode_*`` / ``long_*`` lower ``serve_step`` (one token against a KV cache
of seq_len); ``train_4k`` lowers ``train_step``; ``prefill_32k`` lowers the
prefill pass.  ``long_500k`` runs only for sub-quadratic families
(rwkv6-3b, jamba-v0.1-52b) - skips recorded in EXPERIMENTS.md §Dry-run.
"""

from __future__ import annotations

from repro_torch.configs.base import ShapeConfig

SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", seq_len=4096,
                            global_batch=256, microbatches=16),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", seq_len=32_768,
                               global_batch=32),
    "decode_32k": ShapeConfig("decode_32k", "decode", seq_len=32_768,
                              global_batch=128),
    "long_500k": ShapeConfig("long_500k", "decode", seq_len=524_288,
                             global_batch=1),
}

# families allowed to run long_500k (sub-quadratic state)
LONG_OK_FAMILIES = ("ssm", "hybrid")


def shape_applicable(arch_family: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch_family in LONG_OK_FAMILIES
    return True
