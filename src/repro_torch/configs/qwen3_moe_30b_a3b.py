"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B]: MoE, 128 experts top-8,
expert FFN width 768, no shared expert. The locality-biased router is the
paper's locality-queue technique applied to expert dispatch."""
from .base import ModelConfig, MoEConfig, register


@register("qwen3-moe-30b-a3b")
def qwen3_moe() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
        head_dim=128, d_ff=768, vocab_size=151936,
        rope_theta=1e6, tie_embeddings=False, fsdp=True, microbatches=4,
        moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
    )
