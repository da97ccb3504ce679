"""Phi-3.5-MoE (42B total, 6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct]:
16 experts top-2, expert FFN 6400. At EP=16 exactly one expert lives on each
model-axis device, which makes the locality-vs-balance trade maximally
visible."""
from .base import ModelConfig, MoEConfig, register


@register("phi3.5-moe-42b-a6.6b")
def phi35_moe() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b", family="moe",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=6400, vocab_size=32064,
        rope_theta=1e4, tie_embeddings=False, fsdp=True, microbatches=4,
        moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=6400),
    )
