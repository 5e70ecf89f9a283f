"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536 -
Finch: data-dependent decay [arXiv:2404.05892; hf]."""

from repro_torch.configs.base import ModelConfig, RWKVConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", family="ssm",
        n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
        d_ff=8960, vocab_size=65_536,
        norm="layernorm",
        rwkv=RWKVConfig(head_dim=64, lora_rank=64), remat="dots",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=512, norm="layernorm",
        rwkv=RWKVConfig(head_dim=16, lora_rank=8, chunk=16),
        dtype="float32",
    )
