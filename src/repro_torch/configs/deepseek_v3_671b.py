"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff=2048(expert)
vocab=129280, MoE 256e top-8 + 1 shared, MLA, first 3 layers dense
(dense d_ff=18432) [arXiv:2412.19437; hf].

MTP: DeepSeek-V3's multi-token-prediction module is a training-time
auxiliary head; it is configurable here (``mtp_depth=1``) but kept off in
the dry-run shapes to match serving semantics (see DESIGN.md §4).
"""

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        d_ff=18432, vocab_size=129_280,
        norm="rmsnorm", mlp="swiglu",
        moe=MoEConfig(n_experts=256, top_k=8, expert_ff=2048, n_shared=1,
                      dense_first_n=3, dense_ff=18432),
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b-smoke", family="moe",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=160, vocab_size=512,
        moe=MoEConfig(n_experts=8, top_k=2, expert_ff=32, n_shared=1,
                      dense_first_n=3, dense_ff=160),
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
        dtype="float32",
    )
