"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655
- InternViT frontend STUB (input_specs provides 256 patch embeddings per
sample, prepended) + InternLM2-ish LM [arXiv:2404.16821; hf]."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b", family="vlm",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
        d_ff=4864, vocab_size=151_655,
        norm="rmsnorm", mlp="swiglu", rope_theta=1_000_000.0,
        frontend="vision_prefix", n_prefix_embeds=256, remat="dots",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b-smoke", family="vlm",
        n_layers=2, d_model=56, n_heads=7, n_kv_heads=1,
        d_ff=128, vocab_size=512,
        frontend="vision_prefix", n_prefix_embeds=8,
        dtype="float32",
    )
