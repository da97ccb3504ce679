"""Config registry: one module per assigned architecture (+ the paper's own
Jacobi config in repro_torch.stencil).

The port's own copy of ``repro.configs``: plain dataclasses, copied as they
are, so the port never imports the JAX package."""
from .base import (
    SHAPES,
    EncoderConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    VisionConfig,
    cell_is_applicable,
    get_config,
    list_archs,
    register,
)

_LOADED = False


def _load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    from . import (  # noqa: F401
        gemma3_1b,
        llama32_vision_90b,
        minicpm3_4b,
        phi35_moe_42b,
        qwen2_0_5b,
        qwen2_1_5b,
        qwen3_moe_30b_a3b,
        recurrentgemma_9b,
        rwkv6_3b,
        whisper_base,
    )
    _LOADED = True


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: tiny widths, few
    layers (enough to cover the pattern + a remainder), small vocab."""
    import dataclasses
    nl = max(len(cfg.pattern) + 1, 2)
    kw: dict = dict(
        name=cfg.name + "-smoke",
        num_layers=nl,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2),
        head_dim=16,
        d_ff=96,
        vocab_size=512,
        attn_window=min(cfg.attn_window, 16) if cfg.attn_window else 0,
        fsdp=False,
        microbatches=1,
        dtype="float32",
    )
    if cfg.moe is not None:
        # capacity_factor high enough that nothing is dropped: exact
        # prefill/decode equivalence is testable (capacity-drop behaviour
        # itself is covered by the MoE unit tests)
        kw["moe"] = dataclasses.replace(cfg.moe, num_experts=8, top_k=2,
                                        d_ff_expert=32, capacity_factor=8.0)
        kw["d_ff"] = 32
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                              qk_nope_head_dim=16, qk_rope_head_dim=8,
                              v_head_dim=16)
    if cfg.encoder is not None:
        kw["encoder"] = EncoderConfig(num_layers=2, num_frames=32, d_model=64,
                                      num_heads=4, d_ff=96)
    if cfg.vision is not None:
        kw["vision"] = VisionConfig(num_image_tokens=16,
                                    cross_every=cfg.vision.cross_every)
    return dataclasses.replace(cfg, **kw)
