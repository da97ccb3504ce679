"""Llama-3.2-Vision-90B [hf:meta-llama/Llama-3.2-11B-Vision scaled per the
assignment]: 100-layer decoder with gated cross-attention to vision tokens
every 5th layer. The vision tower is a STUB: input_specs provide precomputed
patch embeddings already projected to d_model."""
from .base import ModelConfig, VisionConfig, register


@register("llama-3.2-vision-90b")
def llama32_vision_90b() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b", family="vlm",
        num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=28672, vocab_size=128256,
        pattern=("full", "full", "full", "full", "cross"),
        rope_theta=5e5, tie_embeddings=False,
        fsdp=True, microbatches=16,
        vision=VisionConfig(num_image_tokens=1600, cross_every=5),
    )
