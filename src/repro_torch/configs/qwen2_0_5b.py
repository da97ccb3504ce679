"""Qwen2-0.5B [arXiv:2407.10671]: dense GQA with QKV bias."""
from .base import ModelConfig, register


@register("qwen2-0.5b")
def qwen2_0_5b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b", family="dense",
        num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
        head_dim=64, d_ff=4864, vocab_size=151936,
        qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
    )
