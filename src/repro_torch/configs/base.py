"""Config system: model/train/serve configs and the ``--arch`` registry
(the port's copy of :mod:`repro.configs.base`, field for field).

One file per assigned architecture lives next to this module; each calls
:func:`register` with the exact published configuration.  Reduced smoke
variants (same family, tiny dims) are derived with :meth:`ModelConfig.smoke`.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

__all__ = [
    "ModelConfig",
    "ShapeSpec",
    "SHAPES",
    "register",
    "get_config",
    "list_archs",
    "shapes_for",
]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters.  Field groups are only read by the
    families that use them (e.g. ``ssm_*`` by mamba2/zamba2)."""

    name: str
    family: str                       # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    vocab: int

    # -- attention --------------------------------------------------------
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    sliding_window: int | None = None        # window for local-attention layers
    local_global: bool = False               # gemma2 alternating pattern
    attn_bias: bool = False                  # qwen2-family qkv bias
    pad_heads_to: int = 0                    # zero-pad query heads (sharding)

    # -- mlp / norm ---------------------------------------------------------
    d_ff: int = 0
    act: str = "swiglu"               # swiglu | geglu | gelu | relu2
    norm: str = "rmsnorm"             # rmsnorm | rmsnorm_offset | ln_nonparam | ln
    post_norms: bool = False          # gemma2 sandwich norms
    tie_embeddings: bool = False

    # -- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    d_expert_ff: int = 0
    n_shared_experts: int = 0         # qwen2-moe shared-expert multiple
    capacity_factor: float = 1.25
    expert_parallel: int = 1          # EP sub-factor of the model axis (§Perf)
    moe_decode_groups: int = 0        # decode dispatch groups (= data shards)
    moe_scan_experts: bool = False    # FSDP: gather one expert at a time

    # -- SSM (mamba2 / SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # -- hybrid (zamba2) ------------------------------------------------------
    attn_every: int = 0               # shared attn block applied every N layers

    # -- enc-dec (whisper) ----------------------------------------------------
    n_enc_layers: int = 0
    enc_frames: int = 1500            # conv-frontend output length (stubbed)

    # -- VLM (qwen2-vl) ---------------------------------------------------------
    mrope_sections: tuple[int, ...] = ()

    # -- numerics / structure -----------------------------------------------
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True          # the reference: lax.scan over the stack
    unroll: bool = False              # accounting build: python-unroll every loop
    q_chunk: int = 0                  # flash-style query chunking (0 = auto)
    seq_parallel: bool = False        # Megatron-SP residual-stream layout
    fsdp: bool = False                # weight-gathered layer params (see partitioning)
    source: str = ""                  # [source; verified-tier] provenance

    # ---------------------------------------------------------------------
    @property
    def d_head(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def smoke(self, **overrides: Any) -> "ModelConfig":
        """A reduced config of the same family for CPU smoke tests."""
        small: dict[str, Any] = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            vocab=256,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=16 if self.n_heads else 0,
            d_ff=128 if self.d_ff else 0,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            d_expert_ff=64 if self.d_expert_ff else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=16,
            capacity_factor=4.0 if self.n_experts else self.capacity_factor,
            attn_every=2 if self.attn_every else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_frames=16 if self.n_enc_layers else 1500,
            sliding_window=16 if self.sliding_window else None,
            mrope_sections=(4, 2, 2) if self.mrope_sections else (),
            dtype="float32",
            remat=False,
            name=self.name + "-smoke",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int
    sub_quadratic_only: bool = False


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1, sub_quadratic_only=True),
}

_REGISTRY: dict[str, ModelConfig] = {}

_ARCH_MODULES = [
    "qwen2_moe_a2_7b",
    "mixtral_8x22b",
    "gemma2_9b",
    "olmo_1b",
    "qwen3_0_6b",
    "minitron_4b",
    "whisper_medium",
    "mamba2_2_7b",
    "zamba2_7b",
    "qwen2_vl_72b",
    "tsqr_paper",
]


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def _load_all() -> None:
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def shapes_for(cfg: ModelConfig) -> list[ShapeSpec]:
    """The assigned shape cells for an architecture.

    ``long_500k`` runs only for sub-quadratic families (SSM / hybrid) —
    pure full-attention archs skip it (DESIGN.md §6).
    """
    out = []
    for spec in SHAPES.values():
        if spec.sub_quadratic_only and cfg.family not in ("ssm", "hybrid"):
            continue
        out.append(spec)
    return out
