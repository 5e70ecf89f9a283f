"""Config schema for the model zoo and the launch system.

Every assigned architecture is one :class:`ModelConfig` instance in
``repro_torch/configs/<id>.py`` plus a reduced ``smoke()`` variant of the same
family for CPU tests.  Shapes come from :class:`ShapeConfig` (the assigned
shape set is :mod:`repro_torch.configs.shapes`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["MoEConfig", "MLAConfig", "MambaConfig", "RWKVConfig",
           "ModelConfig", "ShapeConfig", "TrainConfig"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_ff: int                 # hidden width per expert
    n_shared: int = 0              # shared (always-on) experts
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    # dispatch token-chunk (global tokens per dispatch wave); bounds the
    # (T*k, d) gather/scatter buffers for 1M-token prefills.  XLA keeps
    # some dispatch temporaries unsharded (gather outputs with
    # data-dependent indices), so this is sized to cap the worst case.
    dispatch_chunk: int = 16_384
    # every k-th layer is MoE (jamba: 2); 1 = every layer
    every: int = 1
    # first n layers stay dense (deepseek-v3: 3)
    dense_first_n: int = 0
    dense_ff: int = 0              # d_ff of the dense layers (if any)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0               # 0 -> ceil(d_model / 16)
    chunk: int = 256               # chunked-scan length (remat boundary)


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    lora_rank: int = 64            # ddlerp / decay LoRA rank
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense|moe|hybrid|ssm|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"          # rmsnorm|layernorm
    mlp: str = "swiglu"            # swiglu|gelu
    rope_theta: float = 10_000.0
    parallel_block: bool = False   # cohere-style attn+ffn in parallel
    qk_norm: bool = False          # qwen3-style per-head q/k RMSNorm
    tie_embeddings: bool = False
    max_seq: int = 32_768          # positional bound used by caches
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # hybrid (jamba): one attention layer per `attn_every` layers; others Mamba
    attn_every: int = 0            # 0 = pure attention stack
    attn_offset: int = 4           # index of the attn layer within the period
    # encoder-decoder (whisper): encoder depth & source length
    encoder_layers: int = 0
    encoder_seq: int = 0
    # modality frontend stubs: precomputed embeddings prepended/cross-attended
    frontend: str = "none"         # none|audio_encoder|vision_prefix
    n_prefix_embeds: int = 0       # vision_prefix: patch embeds per sample
    mtp_depth: int = 0             # deepseek multi-token-prediction modules
    dtype: str = "bfloat16"
    # depth-scan remat policy: "full" (recompute everything), "dots"
    # (save matmul outputs - trades HBM for recompute traffic), "none"
    remat: str = "full"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def is_attn_layer(self, i: int) -> bool:
        if self.attn_every <= 0:
            return True
        return i % self.attn_every == self.attn_offset

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        if i < self.moe.dense_first_n:
            return False
        return (i - self.moe.dense_first_n) % self.moe.every == 0

    def param_count(self) -> tuple[int, int]:
        """(total, active) parameter estimates (embeddings included once)."""
        d, dh = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = active = emb

        def ffn_params(ff: int) -> int:
            if self.rwkv is not None:   # squared-relu channel mix: 2 mats
                return 2 * d * ff
            return (3 if self.mlp == "swiglu" else 2) * d * ff

        for i in range(self.n_layers):
            # --- mixer (always active) ---
            if self.mamba is not None and not self.is_attn_layer(i):
                di = self.mamba.expand * d
                dtr = self.mamba.dt_rank or -(-d // 16)
                mixer = (d * 2 * di + di * self.mamba.d_conv
                         + di * (dtr + 2 * self.mamba.d_state) + dtr * di
                         + di * d + di * self.mamba.d_state)
            elif self.rwkv is not None:
                # r,k,v,g,o projections + ddlerp/decay LoRAs (approx.)
                mixer = 5 * d * d + 12 * d * self.rwkv.lora_rank
            elif self.mla is not None:
                m = self.mla
                mixer = (d * m.q_lora_rank
                         + m.q_lora_rank * self.n_heads
                         * (m.qk_nope_dim + m.qk_rope_dim)
                         + d * (m.kv_lora_rank + m.qk_rope_dim)
                         + m.kv_lora_rank * self.n_heads
                         * (m.qk_nope_dim + m.v_head_dim)
                         + self.n_heads * m.v_head_dim * d)
            else:
                mixer = (d * self.n_heads * dh
                         + 2 * d * self.n_kv_heads * dh
                         + self.n_heads * dh * d)
            total += mixer
            active += mixer
            # --- ffn / moe ---
            if self.is_moe_layer(i):
                e = self.moe
                per = ffn_params(e.expert_ff)
                total += (e.n_experts + e.n_shared) * per + d * e.n_experts
                active += (e.top_k + e.n_shared) * per + d * e.n_experts
            else:
                ff = (self.moe.dense_ff if (self.moe and self.moe.dense_ff)
                      else self.d_ff)
                total += ffn_params(ff)
                active += ffn_params(ff)
        return total, active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train|prefill|decode
    seq_len: int
    global_batch: int
    microbatches: int = 1   # grad-accumulation splits of the global batch


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"      # adamw|adafactor|sgd
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    zero1: bool = True            # shard optimizer state over data axis
    grad_compress: str = "none"   # none|int8_ef
    remat: str = "full"           # none|full
    param_dtype: str = "float32"  # master/param dtype
    compute_dtype: str = "bfloat16"
    # grad-accumulation dtype; bf16 halves accumulator memory (used by the
    # 671B train cell - documented precision trade-off)
    acc_dtype: str = "float32"
    # gather FSDP-sharded params ONCE per step (bf16) instead of per
    # microbatch - big collective win for models whose bf16 copy fits HBM
    gather_once: bool = False
