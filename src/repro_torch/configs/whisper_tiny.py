"""whisper-tiny [audio]: 4L enc + 4L dec, d_model=384 6H (kv=6) d_ff=1536
vocab=51865 - encoder-decoder; conv/mel frontend is a STUB (input_specs
provides precomputed frame embeddings (B, 1500, 384))
[arXiv:2212.04356; unverified]."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", family="audio",
        n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
        d_ff=1536, vocab_size=51_865,
        norm="layernorm", mlp="gelu",
        encoder_layers=4, encoder_seq=1500, frontend="audio_encoder",
        max_seq=32_768,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=512, norm="layernorm", mlp="gelu",
        encoder_layers=2, encoder_seq=32, frontend="audio_encoder",
        max_seq=128,
        dtype="float32",
    )
