"""Model: the public API over the decoder stack.

The port of ``repro.models.model``, with the reference's functional
interface, so the serving engine ports line for line:

    model = build_model(cfg)                         # device="cuda" by default
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    loss, metrics = model.loss_fn(params, batch)
    logits, caches = model.prefill(params, batch, caches)
    logits, caches = model.decode_step(params, tokens, pos, caches)

``params`` is a dict of tensors (the stack a list of per-layer dicts, see
``transformer``).  The model runs eagerly on its device: ``cuda`` unless
the caller passes ``device="cpu"``, and it raises without a card.  On the
card attention runs in K3, the RWKV recurrence in K4 and the RG-LRU scan
in K5 unless ``use_kernel=False`` asks for the plain versions.

All ten architectures build.  Whisper's encoder (``_encode``: the stack at
the encoder's widths, without a causal mask, with sinusoidal positions and
no rope) turns ``extras["frames"]`` into the decoder's cross-attention
input, and its decoder adds learned positions (``dec_pos``); the VLM takes
``extras["vision"]`` (patch embeddings already at the decoder's width) as
its cross-attention input.  MoE and MLA live in ``models/moe.py`` and
``models/mla.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .._device import resolve_device
from ..configs.base import ModelConfig
from .common import (Params, cross_entropy, embed_init, layer_norm,
                     layer_norm_init, rms_norm, rms_norm_init,
                     sinusoidal_positions)
from .transformer import apply_stack, stack_cache_specs, stack_init

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _enc_cfg(cfg: ModelConfig) -> ModelConfig:
    e = cfg.encoder
    return dataclasses.replace(
        cfg, num_layers=e.num_layers, d_model=e.d_model,
        num_heads=e.num_heads, num_kv_heads=e.num_heads,
        head_dim=e.d_model // e.num_heads, d_ff=e.d_ff,
        pattern=("full",), moe=None, mla=None, vision=None,
        qkv_bias=False, rope_theta=0.0)


class Model:
    def __init__(self, cfg: ModelConfig, max_pos: int = 4096, *,
                 device: str | torch.device | None = None,
                 use_kernel: bool = True):
        self.cfg = cfg
        self.max_pos = max_pos
        self.dtype = _DTYPES[cfg.dtype]
        self.device = resolve_device(device)
        self.use_kernel = use_kernel
        # gemma's and the hybrid family's embedding scale, sqrt(d_model)
        # rounded to the model's dtype first, as the reference rounds it
        # (64.0 at d 4096; 33.94 at gemma3-1b's 1152 is no bf16 number)
        self._embed_scale = None
        if (cfg.family == "dense" and cfg.name.startswith("gemma")) or \
                cfg.family == "hybrid":
            self._embed_scale = torch.tensor(cfg.d_model ** 0.5,
                                             dtype=self.dtype).item()

    # -- parameters ---------------------------------------------------------
    def init_params(self, generator: torch.Generator) -> Params:
        """Random parameters at the config's widths, drawn from
        ``generator`` (which must live on the model's device)."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        cfg = self.cfg
        dt = self.dtype
        p: Params = {
            "tok": embed_init(generator, cfg.vocab_padded(), cfg.d_model, dt),
            "final_norm": (rms_norm_init(cfg.d_model, dt, generator.device)
                           if cfg.norm == "rms" else
                           layer_norm_init(cfg.d_model, dt, generator.device)),
            "stack": stack_init(generator, cfg, dt),
        }
        if not cfg.tie_embeddings:
            p["head"] = embed_init(generator, cfg.vocab_padded(), cfg.d_model,
                                   dt).T.contiguous()
        if cfg.encoder is not None:
            ecfg = _enc_cfg(cfg)
            p["encoder"] = {
                "stack": stack_init(generator, ecfg, dt),
                "final_norm": (layer_norm_init(ecfg.d_model, dt, generator.device)
                               if cfg.norm == "layer" else
                               rms_norm_init(ecfg.d_model, dt, generator.device)),
            }
            # whisper's decoder uses learned absolute positions
            p["dec_pos"] = (torch.randn((self.max_pos, cfg.d_model), generator=generator,
                                        device=generator.device) * 0.01).to(dt)
        return p

    # -- encoder (whisper) ----------------------------------------------------
    def _encode(self, params: Params, frames: torch.Tensor) -> torch.Tensor:
        ecfg = _enc_cfg(self.cfg)
        pos = sinusoidal_positions(frames.shape[1], ecfg.d_model,
                                   frames.device).to(frames.dtype)
        x, _, _ = apply_stack(params["encoder"]["stack"], frames + pos[None], ecfg,
                              pos_offset=0, causal=False, use_kernel=self.use_kernel)
        if self.cfg.norm == "layer":
            return layer_norm(params["encoder"]["final_norm"], x)
        return rms_norm(params["encoder"]["final_norm"], x)

    # -- forward --------------------------------------------------------------
    def forward(self, params: Params, tokens: torch.Tensor, *,
                extras: Optional[dict[str, torch.Tensor]] = None,
                pos_offset: int = 0, caches: Optional[list[Params]] = None,
                last_only: bool = False):
        """Returns (logits, new_caches, aux)."""
        cfg = self.cfg
        x = params["tok"][tokens]
        if self._embed_scale is not None:
            x = x * self._embed_scale

        cross_x = None
        if cfg.encoder is not None:
            if extras is not None and "frames" in extras:
                cross_x = self._encode(params, extras["frames"])
            t = tokens.shape[1]
            x = x + params["dec_pos"][pos_offset:pos_offset + t][None]
        elif cfg.vision is not None and extras is not None and "vision" in extras:
            cross_x = extras["vision"]

        x, new_caches, aux = apply_stack(
            params["stack"], x, cfg, pos_offset=pos_offset, caches=caches,
            cross_x=cross_x, use_kernel=self.use_kernel)

        if cfg.norm == "rms":
            x = rms_norm(params["final_norm"], x)
        else:
            x = layer_norm(params["final_norm"], x)
        if last_only:
            x = x[:, -1:]
        head = params["head"] if not cfg.tie_embeddings else params["tok"].T
        logits = x @ head.to(x.dtype)
        return logits, new_caches, aux

    # -- train ---------------------------------------------------------------
    def loss_fn(self, params: Params, batch: dict[str, torch.Tensor]):
        logits, _, aux = self.forward(params, batch["tokens"], extras=batch)
        ce = cross_entropy(logits, batch["labels"])
        return ce + aux, {"ce": ce, "aux": aux}

    # -- serve ---------------------------------------------------------------
    def prefill(self, params: Params, batch: dict[str, torch.Tensor],
                caches: list[Params]):
        logits, caches, _ = self.forward(params, batch["tokens"],
                                         extras=batch, pos_offset=0,
                                         caches=caches, last_only=True)
        return logits, caches

    def decode_step(self, params: Params, tokens: torch.Tensor,
                    pos: int, caches: list[Params]):
        """tokens (B, 1); pos = number of tokens already in the cache."""
        logits, caches, _ = self.forward(params, tokens, pos_offset=int(pos),
                                         caches=caches)
        return logits, caches

    def init_cache(self, batch: int, max_seq: int) -> list[Params]:
        """Zeroed per-layer caches on the model's device."""
        specs = stack_cache_specs(self.cfg, batch, max_seq, self.dtype)
        return [{name: torch.zeros(shape, dtype=dt, device=self.device)
                 for name, (shape, dt) in spec.items()} for spec in specs]


def build_model(cfg: ModelConfig, max_pos: int = 4096, *,
                device: str | torch.device | None = None,
                use_kernel: bool = True) -> Model:
    return Model(cfg, max_pos=max_pos, device=device, use_kernel=use_kernel)
