"""Whisper-base [arXiv:2212.04356]: encoder-decoder; conv frontend is a STUB
(input_specs provide precomputed frame embeddings, padded 1500->1536 frames
for lane-friendly sharding). Decoder layers = self+cross attention.

train_4k/decode_32k decoder lengths exceed Whisper's trained 448 positions;
kept as lowering/scale exercises per the assignment (see DESIGN.md §5)."""
from .base import EncoderConfig, ModelConfig, register


@register("whisper-base")
def whisper_base() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="encdec",
        num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
        head_dim=64, d_ff=2048, vocab_size=51865,
        pattern=("cross",), act="gelu", norm="layer",
        rope_theta=0.0,  # whisper uses absolute positions, not rope
        tie_embeddings=True,
        encoder=EncoderConfig(num_layers=6, num_frames=1536, d_model=512,
                              num_heads=8, d_ff=2048),
    )
