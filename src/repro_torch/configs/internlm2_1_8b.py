"""internlm2-1.8b [dense]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544 - GQA [arXiv:2403.17297; hf]."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b", family="dense",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
        d_ff=8192, vocab_size=92_544,
        norm="rmsnorm", mlp="swiglu", rope_theta=1_000_000.0, remat="dots",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=512,
        dtype="float32",
    )
