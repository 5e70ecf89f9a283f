"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936 - GQA with QKV bias [hf:Qwen/Qwen2.5; hf]."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b", family="dense",
        n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
        head_dim=128, d_ff=11008, vocab_size=151_936,
        qkv_bias=True, norm="rmsnorm", mlp="swiglu",
        rope_theta=1_000_000.0, tie_embeddings=True, remat="dots",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, qkv_bias=True, tie_embeddings=True,
        dtype="float32",
    )
