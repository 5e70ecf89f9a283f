"""Architecture registry of the LM face: ``get(name)`` resolves here.

``get(name)`` -> full ModelConfig; ``get_smoke(name)`` -> reduced same-family
config for CPU tests.  A copy of the reference's registry
(``src/repro/configs``); the port builds and serves every arch.
"""

from __future__ import annotations

import importlib

_ARCH_MODULES = {
    "qwen2.5-3b": "qwen2_5_3b",
    "phi3-medium-14b": "phi3_medium_14b",
    "command-r-plus-104b": "command_r_plus_104b",
    "internlm2-1.8b": "internlm2_1_8b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "rwkv6-3b": "rwkv6_3b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "whisper-tiny": "whisper_tiny",
    "internvl2-1b": "internvl2_1b",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def _module(name: str):
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}")


def get(name: str):
    return _module(name).config()


def get_smoke(name: str):
    return _module(name).smoke()
