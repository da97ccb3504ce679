"""Gemma3-1B [hf:google/gemma-3-1b-pt]: 5:1 local:global attention,
MQA (1 KV head), 262k vocab. Local layers use a 512-token sliding window,
which keeps decode sub-quadratic (ring-buffer KV) -> long_500k applies."""
from .base import ModelConfig, register


@register("gemma3-1b")
def gemma3_1b() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b", family="dense",
        num_layers=26, d_model=1152, num_heads=4, num_kv_heads=1,
        head_dim=256, d_ff=6912, vocab_size=262144,
        pattern=("local", "local", "local", "local", "local", "full"),
        attn_window=512, rope_theta=1e6, act="gelu",
        tie_embeddings=True, microbatches=2, subquadratic=True,
    )
