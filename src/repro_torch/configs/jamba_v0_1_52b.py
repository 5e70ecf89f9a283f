"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 - Mamba+attn 1:7 interleave, MoE every 2
[arXiv:2403.19887; hf]."""

from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=65_536,
        norm="rmsnorm", mlp="swiglu",
        moe=MoEConfig(n_experts=16, top_k=2, expert_ff=14336, every=2),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
        attn_every=8, attn_offset=4,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b-smoke", family="hybrid",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=512,
        moe=MoEConfig(n_experts=4, top_k=2, expert_ff=128, every=2),
        mamba=MambaConfig(d_state=8, d_conv=4, expand=2, chunk=16),
        attn_every=8, attn_offset=4,
        dtype="float32",
    )
