"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff=768(expert)
vocab=151936, MoE 128e top-8, head_dim=128, q/k RMSNorm
[hf:Qwen/Qwen3-30B-A3B; hf]."""

from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
        head_dim=128, d_ff=768, vocab_size=151_936,
        norm="rmsnorm", mlp="swiglu", qk_norm=True,
        rope_theta=1_000_000.0,
        moe=MoEConfig(n_experts=128, top_k=8, expert_ff=768), remat="dots",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab_size=512, qk_norm=True,
        moe=MoEConfig(n_experts=8, top_k=2, expert_ff=32),
        dtype="float32",
    )
