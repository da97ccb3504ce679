"""Model/config registry for the assigned architectures.

Every architecture is a ``ModelConfig``; reduced smoke variants share the
same code paths with tiny dimensions.  Input-shape sets (train_4k /
prefill_32k / decode_32k / long_500k) are defined here too, so dryrun,
benchmarks and tests agree on every (arch x shape) cell.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    locality_bias: float = 0.0      # paper-technique: bias router toward
                                    # experts resident on the token's devices
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder for enc-dec archs (whisper). Frontend is a stub: input_specs
    provide precomputed frame embeddings (post-conv)."""
    num_layers: int
    num_frames: int                 # padded to a lane-friendly multiple
    d_model: int
    num_heads: int
    d_ff: int


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """Vision frontend stub for VLMs: precomputed patch embeddings,
    already projected to the decoder width."""
    num_image_tokens: int
    cross_every: int                # one cross-attn layer per this many


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # layer pattern: repeating kinds; remainder unrolled.
    #   kinds: "full" global attn, "local" sliding-window attn,
    #          "rglru" recurrent block, "cross" self+cross-attn, "rwkv"
    pattern: tuple[str, ...] = ("full",)
    attn_window: int = 0            # sliding window for "local" layers
    qkv_bias: bool = False
    rope_theta: float = 1e4
    act: str = "silu"
    norm: str = "rms"               # rms | layer
    tie_embeddings: bool = True
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionConfig] = None
    # rwkv
    rwkv_head_dim: int = 64
    # distribution hints
    fsdp: bool = False              # shard weights over the data axis too
    remat: bool = True
    microbatches: int = 1           # grad-accumulation steps per train step
    dtype: str = "bfloat16"
    # long_500k applicability (sub-quadratic attention path exists)
    subquadratic: bool = False

    # -- derived -----------------------------------------------------------
    def vocab_padded(self, multiple: int = 128) -> int:
        return math.ceil(self.vocab_size / multiple) * multiple

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def layer_kinds(self) -> list[str]:
        """Expanded per-layer kind list of length num_layers."""
        reps = self.num_layers // len(self.pattern)
        rem = self.num_layers - reps * len(self.pattern)
        return list(self.pattern) * reps + list(self.pattern[:rem])

    def num_params(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_padded()
        n_attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        n_mlp = 3 * d * f if self.act in ("silu",) else 2 * d * f
        total = v * d * (1 if self.tie_embeddings else 2)
        for kind in self.layer_kinds():
            if kind in ("full", "local", "cross"):
                total += n_attn + n_mlp + 2 * d
                if kind == "cross":
                    total += n_attn + d
            elif kind == "rglru":
                total += 2 * d * d + d * d + n_mlp + 2 * d   # branches+proj
            elif kind == "rwkv":
                total += 5 * d * d + 2 * d * f + 4 * d
            if self.moe is not None and kind in ("full", "local"):
                total += -n_mlp + self.moe.num_experts * 3 * d * self.moe.d_ff_expert \
                    + d * self.moe.num_experts
        if self.mla is not None:
            m = self.mla
            per = (d * m.q_lora_rank
                   + m.q_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                   + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                   + m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
                   + self.num_heads * m.v_head_dim * d)
            total += self.num_layers * (per - n_attn)
        return total

    def active_params(self) -> int:
        """Active parameters per token (MoE: only top-k experts count)."""
        if self.moe is None:
            return self.num_params()
        d = self.d_model
        full = self.num_params()
        inactive = (self.moe.num_experts - self.moe.top_k) * 3 * d * self.moe.d_ff_expert
        return full - len([k for k in self.layer_kinds() if k in ("full", "local")]) * inactive


# ---------------------------------------------------------------------------
# input shapes (assigned): every LM arch carries these four cells
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # import the arch modules lazily on first miss
        from . import _load_all  # noqa: F401  (populates the registry)
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    from . import _load_all
    _load_all()
    return sorted(_REGISTRY)


def cell_is_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch x shape) cell runs; reason if skipped (DESIGN §5)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: long_500k needs sub-quadratic attention"
    return True, ""
