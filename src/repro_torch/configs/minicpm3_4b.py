"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B]: dense with Multi-head Latent
Attention (MLA). The KV cache stores only the compressed latent
(kv_lora_rank) plus the shared rope key."""
from .base import MLAConfig, ModelConfig, register


@register("minicpm3-4b")
def minicpm3_4b() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b", family="dense",
        num_layers=62, d_model=2560, num_heads=40, num_kv_heads=40,
        head_dim=64, d_ff=6400, vocab_size=73448,
        rope_theta=1e4, tie_embeddings=True, microbatches=8,
        mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                      qk_nope_head_dim=64, qk_rope_head_dim=32,
                      v_head_dim=64),
    )
