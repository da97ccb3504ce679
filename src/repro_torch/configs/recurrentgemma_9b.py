"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427]: RG-LRU recurrent blocks
and local-attention blocks at 2:1, MQA, window 2048. O(1) decode state ->
long_500k applies."""
from .base import ModelConfig, register


@register("recurrentgemma-9b")
def recurrentgemma_9b() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
        head_dim=256, d_ff=12288, vocab_size=256000,
        pattern=("rglru", "rglru", "local"),
        attn_window=2048, rope_theta=1e4, act="gelu",
        tie_embeddings=True, fsdp=True, microbatches=4, subquadratic=True,
    )
