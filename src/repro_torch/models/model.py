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
its cross-attention input.  Both extras are cast to the model's dtype
first, the dtype the reference declares for them (divergence P22):
``launch.train`` makes them in f32, which PyTorch's matmul would refuse
in a bf16 model beside bf16 weights (the reference's bf16 model refuses
them too, in its layer scan).  MoE and MLA live in ``models/moe.py`` and
``models/mla.py``.

Sharding: ``param_logical_axes`` gives every parameter leaf
its logical axes from the reference's ``_LEAF_AXES``/``_MOE_LEAF_AXES``
tables, and ``param_shardings`` their DTensor placements under a
``ShardingRules`` (``distributed/sharding.py``); ``place`` puts a tree on
the mesh.  A model whose parameters are DTensors, run under ``use_rules``,
runs sharded: the reference's ``shard`` constraints are back at its sites,
and the kernels run on local shards.  ``abstract_params``, ``input_specs``
and ``cache_specs`` are ``meta`` tensors: shapes and dtypes with no memory,
at full width too (the reference's ``jax.eval_shape`` and
``ShapeDtypeStruct``s).  The port's stack is a list of per-layer dicts, so
its leaves have no stacked leading axis: a leaf's logical axes are the
table's entry itself.  One site differs under a mesh for DTensor's sake:
token ids that are a DTensor are looked up on each rank's shards (the
table gathered whole, the rank's batch rows of ids, the plain indexing),
because PyTorch 2.11's sharding rule for the ``index_put`` in indexing's
backward fails on sharded ids.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .._device import resolve_device
from .._tree import flatten_with_path, unflatten
from ..configs.base import ModelConfig, ShapeConfig
from ..distributed.sharding import as_dtensor, is_dtensor, on_local_shards, shard
from .common import (Params, abstract_init, cross_entropy, draw_device, embed_init,
                     layer_norm, layer_norm_init, rms_norm, rms_norm_init,
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
        if draw_device(generator).type not in ("meta", self.device.type):
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        cfg = self.cfg
        dt = self.dtype
        p: Params = {
            "tok": embed_init(generator, cfg.vocab_padded(), cfg.d_model, dt),
            "final_norm": (rms_norm_init(cfg.d_model, dt, draw_device(generator))
                           if cfg.norm == "rms" else
                           layer_norm_init(cfg.d_model, dt, draw_device(generator))),
            "stack": stack_init(generator, cfg, dt),
        }
        if not cfg.tie_embeddings:
            p["head"] = embed_init(generator, cfg.vocab_padded(), cfg.d_model,
                                   dt).T.contiguous()
        if cfg.encoder is not None:
            ecfg = _enc_cfg(cfg)
            p["encoder"] = {
                "stack": stack_init(generator, ecfg, dt),
                "final_norm": (layer_norm_init(ecfg.d_model, dt, draw_device(generator))
                               if cfg.norm == "layer" else
                               rms_norm_init(ecfg.d_model, dt, draw_device(generator))),
            }
            # whisper's decoder uses learned absolute positions
            p["dec_pos"] = (torch.randn((self.max_pos, cfg.d_model), generator=generator,
                                        device=draw_device(generator)) * 0.01).to(dt)
        return p

    def abstract_params(self) -> Params:
        """The parameter tree as ``meta`` tensors: no memory, no draws."""
        with abstract_init():
            return self.init_params(torch.Generator())

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
        if is_dtensor(tokens):
            # under a mesh, on local shards (PyTorch 2.11's sharding rule
            # for the index_put of indexing's backward fails on sharded ids)
            x = on_local_shards(lambda tok, ids: tok[ids],
                                [(params["tok"], (None, None)), (tokens, ("batch", None))],
                                ("batch", None, None))
        else:
            x = params["tok"][tokens]
        if self._embed_scale is not None:
            x = x * self._embed_scale
        x = shard(x, "batch", None, None)

        # frames and image tokens join the stream in the model's dtype (P22)
        cross_x = None
        if cfg.encoder is not None:
            if extras is not None and "frames" in extras:
                cross_x = self._encode(params, extras["frames"].to(self.dtype))
            t = tokens.shape[1]
            x = x + params["dec_pos"][pos_offset:pos_offset + t][None]
        elif cfg.vision is not None and extras is not None and "vision" in extras:
            cross_x = extras["vision"].to(self.dtype)

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
        x = shard(x, "batch", None, None)
        logits = x @ head.to(x.dtype)
        logits = shard(logits, "batch", None, "vocab")
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

    # -- specs (abstract inputs) ----------------------------------------------
    def input_specs(self, shape: ShapeConfig) -> dict[str, torch.Tensor]:
        """The batch of a ``shape`` cell as ``meta`` tensors."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        i32, dt = torch.int32, self.dtype

        def meta(shp, dtype):
            return torch.empty(shp, dtype=dtype, device="meta")

        if shape.kind == "train":
            specs = {"tokens": meta((b, s), i32), "labels": meta((b, s), i32)}
        elif shape.kind == "prefill":
            specs = {"tokens": meta((b, s), i32)}
        else:  # decode
            specs = {"tokens": meta((b, 1), i32)}
        if cfg.encoder is not None and shape.kind != "decode":
            e = cfg.encoder
            specs["frames"] = meta((b, e.num_frames, e.d_model), dt)
        if cfg.vision is not None and shape.kind != "decode":
            specs["vision"] = meta((b, cfg.vision.num_image_tokens, cfg.d_model), dt)
        return specs

    def cache_specs(self, shape: ShapeConfig) -> list[Params]:
        """The per-layer decode caches of a ``shape`` cell as ``meta`` tensors."""
        specs = stack_cache_specs(self.cfg, shape.global_batch, shape.seq_len, self.dtype)
        return [{name: torch.empty(shp, dtype=dt, device="meta")
                 for name, (shp, dt) in spec.items()} for spec in specs]

    def init_cache(self, batch: int, max_seq: int) -> list[Params]:
        """Zeroed per-layer caches on the model's device."""
        specs = stack_cache_specs(self.cfg, batch, max_seq, self.dtype)
        return [{name: torch.zeros(shape, dtype=dt, device=self.device)
                 for name, (shape, dt) in spec.items()} for spec in specs]


def build_model(cfg: ModelConfig, max_pos: int = 4096, *,
                device: str | torch.device | None = None,
                use_kernel: bool = True) -> Model:
    return Model(cfg, max_pos=max_pos, device=device, use_kernel=use_kernel)


# ---------------------------------------------------------------------------
# parameter logical axes (for DTensor placements via distributed.sharding rules)
# ---------------------------------------------------------------------------

_LEAF_AXES: dict[str, tuple] = {
    "tok": ("vocab", None),
    "head": (None, "vocab"),
    "dec_pos": (None, None),
    "wq": ("fsdp", "qheads"),
    "wk": ("fsdp", None),
    "wv": ("fsdp", None),
    "wo": ("qheads", "fsdp"),
    "bq": ("qheads",), "bk": (None,), "bv": (None,),
    "w_up": ("fsdp", "ffn"), "w_gate": ("fsdp", "ffn"),
    "w_down": ("ffn", "fsdp"),
    "router": (None, None),
    # MLA
    "w_dq": ("fsdp", None), "w_uq": (None, "qheads"),
    "w_dkv": ("fsdp", None), "w_uk": (None, "qheads"),
    "w_uv": (None, "qheads"), "w_kr": (None, None),
    # RG-LRU
    "w_gate_branch": ("fsdp", "lru"), "w_x_branch": ("fsdp", "lru"),
    "conv_w": (None, "lru"), "conv_b": ("lru",),
    # block-diagonal gates: block dim sharded like the lru channels, so the
    # per-block matmuls contract entirely within a shard (no collective)
    "w_a": ("lru_blocks", None, None), "b_a": ("lru",),
    "w_i": ("lru_blocks", None, None), "b_i": ("lru",),
    "lam": ("lru",), "w_out": ("lru", "fsdp"),
    # RWKV
    "w_r": ("fsdp", None), "w_k": ("fsdp", None), "w_v": ("fsdp", None),
    "w_g": ("fsdp", None), "w_o": ("fsdp", None),
    "decay_lora_a": ("fsdp", None), "decay_lora_b": (None, None),
    "mix_lora_a": ("fsdp", None), "mix_lora_b": (None, None),
    "mix_base": (None, None), "decay_base": (None,),
    "u": (None, None), "gn_scale": (None,), "gn_bias": (None,),
    "w_ck": ("fsdp", "rwkv_ffn"), "w_cv": ("rwkv_ffn", "fsdp"),
    "w_cr": ("fsdp", None),
    "cmix_k": (None,), "cmix_r": (None,),
}

_MOE_LEAF_AXES = {
    "w_gate": ("experts", "fsdp", None),
    "w_up": ("experts", "fsdp", None),
    "w_down": ("experts", None, "fsdp"),
}


def _leaf_axes(path: str, leaf) -> tuple:
    """A leaf's logical axes from its ``/``-joined path (``_tree``'s form)."""
    names = path.split("/")
    name = names[-1]
    table = _MOE_LEAF_AXES if ("moe" in names and name in _MOE_LEAF_AXES) else _LEAF_AXES
    axes = table.get(name)
    nd = len(leaf.shape)
    if axes is None:
        return (None,) * nd
    if len(axes) < nd:                 # stacked leading axes (none in the port's stack)
        return (None,) * (nd - len(axes)) + tuple(axes)
    return tuple(axes[:nd])


def param_logical_axes(cfg: ModelConfig, params: Params):
    """Tree of logical-axis tuples matching the params tree."""
    return unflatten(params, [_leaf_axes(path, leaf)
                              for path, leaf in flatten_with_path(params)])


def param_shardings(cfg: ModelConfig, params: Params, rules):
    """DTensor placements (one list per leaf) for every param leaf under
    the given rules."""
    return unflatten(params, [rules.sharding(*_leaf_axes(path, leaf))
                              for path, leaf in flatten_with_path(params)])


def place(tree: Any, shardings: Any, rules) -> Any:
    """Every leaf of ``tree`` as a DTensor with the placements of the
    matching leaf of ``shardings``.  A plain leaf must be the same tensor
    on every rank: each rank keeps its own shard, nothing is sent; a
    DTensor leaf is redistributed."""
    out = [as_dtensor(x, rules.mesh).redistribute(rules.mesh, want)
           for (_, x), want in zip(flatten_with_path(tree), _placement_leaves(tree, shardings))]
    return unflatten(tree, out)


def _placement_leaves(tree: Any, shardings: Any) -> list:
    """The placement lists of ``shardings`` in the order of ``tree``'s
    leaves (a placement list is a leaf there, not a subtree)."""
    out = []

    def walk(t, sh):
        if t is None:
            return
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], sh[k])
        elif isinstance(t, (list, tuple)):
            for a, b in zip(t, sh):
                walk(a, b)
        else:
            out.append(sh)

    walk(tree, shardings)
    return out
