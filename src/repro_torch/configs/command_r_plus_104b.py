"""command-r-plus-104b [dense]: 64L d_model=12288 96H (GQA kv=8) d_ff=33792
vocab=256000 - GQA, no-bias, cohere parallel attn+FFN block, tied embeddings
[hf:CohereForAI/c4ai-command-r; unverified]."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b", family="dense",
        n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
        d_ff=33792, vocab_size=256_000,
        norm="layernorm", mlp="swiglu", rope_theta=75_000_000.0,
        parallel_block=True, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=512, norm="layernorm",
        parallel_block=True, tie_embeddings=True,
        dtype="float32",
    )
