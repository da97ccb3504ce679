"""RWKV-6 "Finch" 3B [arXiv:2404.05892]: attention-free; data-dependent
per-channel decay (time-mix) + relu^2 channel-mix. O(1) decode state ->
long_500k applies. Attention-sharding aspects of the paper's technique are
inapplicable (DESIGN.md §5); the arch is implemented fully regardless."""
from .base import ModelConfig, register


@register("rwkv6-3b")
def rwkv6_3b() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", family="ssm",
        num_layers=32, d_model=2560, num_heads=0, num_kv_heads=0,
        head_dim=0, d_ff=8960, vocab_size=65536,
        pattern=("rwkv",), act="relu2", norm="layer",
        rope_theta=0.0, tie_embeddings=False,
        rwkv_head_dim=64, microbatches=8, subquadratic=True,
    )
