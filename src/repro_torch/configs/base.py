"""Model/architecture configuration system.

Every assigned architecture is expressed as a ``ModelConfig`` built from a
small set of composable layer kinds (attention variants, SSM variants, dense
or MoE MLPs).  ``reduced()`` derives the CPU smoke-test version of any config
(same family, tiny dims).  The registry maps ``--arch <id>`` to its config.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

VOCAB_PAD_MULTIPLE = 256  # pad embedding tables for clean model-axis sharding


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    n_shared: int = 0             # always-on shared experts (DeepSeek-V2)
    capacity_factor: float = 1.25
    moe_layers: str = "all"       # "all" | "odd" | "even"

    def is_moe_layer(self, idx: int) -> bool:
        if self.moe_layers == "all":
            return True
        if self.moe_layers == "odd":
            return idx % 2 == 1
        if self.moe_layers == "even":
            return idx % 2 == 0
        raise ValueError(self.moe_layers)


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 -> ceil(d_model/16)

    def inner(self, d_model: int) -> int:
        return self.expand * d_model

    def rank(self, d_model: int) -> int:
        return self.dt_rank or -(-d_model // 16)


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64          # data-dependent decay LoRA rank (Finch)
    tokenshift_lora: int = 32

    def n_heads(self, d_model: int) -> int:
        return d_model // self.head_dim


@dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder (conv frontend stubbed to frame embeddings)."""

    n_layers: int = 4
    n_frames: int = 1500


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0               # 0 -> d_model // n_heads
    # layer layout: a string of per-layer kinds, cycled over n_layers.
    # 'a' = attention, 'l' = latent attention (MLA), 'm' = mamba, 'r' = rwkv6
    layer_pattern: str = "a"
    # attention details
    qkv_bias: bool = False
    mlp_bias: bool = False
    rope: bool = True
    rope_theta: float = 1e4
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    act: str = "silu"             # silu | gelu
    tie_embeddings: bool = False
    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    encoder: Optional[EncoderConfig] = None
    # modality frontend stub: none | audio | vision
    frontend: str = "none"
    n_frontend_tokens: int = 0    # precomputed embedding tokens (vlm stub)
    # citation metadata
    source: str = ""

    # ------------------------------------------------------------------ #
    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        m = VOCAB_PAD_MULTIPLE
        return ((self.vocab_size + m - 1) // m) * m

    def layer_kind(self, idx: int) -> str:
        return self.layer_pattern[idx % len(self.layer_pattern)]

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        return tuple(self.layer_kind(i) for i in range(self.n_layers))

    @property
    def is_homogeneous(self) -> bool:
        return len(set(self.layer_kinds)) == 1 and (
            self.moe is None or self.moe.moe_layers == "all")

    @property
    def group_size(self) -> int:
        """Layers per scan group (heterogeneous archs scan over groups)."""
        if self.is_homogeneous:
            return 1
        g = len(self.layer_pattern)
        if self.moe is not None and self.moe.moe_layers != "all":
            g = g * 2 if g % 2 == 1 else g
        assert self.n_layers % g == 0, (self.n_layers, g)
        return g

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.group_size

    @property
    def uses_attention(self) -> bool:
        return any(k in ("a", "l") for k in self.layer_kinds)

    @property
    def sub_quadratic(self) -> bool:
        """True when the arch can serve 500k contexts (SSM/hybrid)."""
        return any(k in ("m", "r") for k in self.layer_kinds)

    # ------------------------------------------------------------------ #
    def reduced(self) -> "ModelConfig":
        """CPU smoke-test twin: same family/topology, tiny dimensions."""
        changes: Dict = dict(
            n_layers=min(self.n_layers, 2 * self.group_size),
            d_model=128,
            n_heads=min(self.n_heads, 4) or 0,
            n_kv_heads=min(self.n_kv_heads, 2) or 0,
            d_head=32 if self.n_heads else 0,
            d_ff=256,
            vocab_size=512,
        )
        if self.moe:
            changes["moe"] = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2), d_expert=64)
        if self.mla:
            changes["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                                       qk_nope_head_dim=32, qk_rope_head_dim=16,
                                       v_head_dim=32)
        if self.mamba:
            changes["mamba"] = MambaConfig(d_state=8, d_conv=4, expand=2)
        if self.rwkv:
            changes["rwkv"] = RWKVConfig(head_dim=32, decay_lora=16,
                                         tokenshift_lora=8)
            changes["n_heads"] = 128 // 32
        if self.encoder:
            changes["encoder"] = EncoderConfig(n_layers=2, n_frames=16)
        if self.n_frontend_tokens:
            changes["n_frontend_tokens"] = 8
        return dataclasses.replace(self, **changes)

    # ------------------------------------------------------------------ #
    # parameter counting (for MODEL_FLOPS in the roofline)
    # ------------------------------------------------------------------ #
    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        if self.mla is not None:
            m = self.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            p = d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk   # q path
            p += d * (m.kv_lora_rank + m.qk_rope_head_dim)              # kv down
            p += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim
                                                  + m.v_head_dim)       # kv up
            p += self.n_heads * m.v_head_dim * d                        # o proj
            return p
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        bias = (self.n_heads + 2 * self.n_kv_heads) * hd if self.qkv_bias else 0
        return q + kv + o + bias

    def _mamba_params(self) -> int:
        m = self.mamba
        d, di = self.d_model, m.inner(self.d_model)
        r = m.rank(self.d_model)
        return (d * 2 * di + di * m.d_conv + di * (r + 2 * m.d_state)
                + r * di + di * m.d_state + di + di * d)

    def _rwkv_params(self) -> int:
        r = self.rwkv
        d = self.d_model
        lora = 5 * r.tokenshift_lora * 2 * d + d * r.decay_lora + r.decay_lora * d
        return 4 * d * d + d * d + lora  # r,k,v,g,o + decay paths (approx)

    def _mlp_params(self, layer_idx: int) -> Tuple[int, int]:
        """(total, active) MLP params at one layer."""
        d = self.d_model
        if self.moe is not None and self.moe.is_moe_layer(layer_idx):
            e = self.moe
            per = 3 * d * e.d_expert          # gate/up/down (gated silu)
            total = (e.n_experts + e.n_shared) * per + d * e.n_experts  # + router
            active = (e.top_k + e.n_shared) * per + d * e.n_experts
            return total, active
        per = 3 * d * self.d_ff if self.act == "silu" else 2 * d * self.d_ff
        return per, per

    def param_counts(self) -> Tuple[int, int]:
        """(total, active) parameter counts, excluding embeddings for the
        6ND rule (embeddings contribute negligible matmul FLOPs)."""
        total = active = 0
        for i, kind in enumerate(self.layer_kinds):
            if kind in ("a", "l"):
                p = self._attn_params()
            elif kind == "m":
                p = self._mamba_params()
            elif kind == "r":
                p = self._rwkv_params()
            else:
                raise ValueError(kind)
            total += p
            active += p
            t, a = self._mlp_params(i)
            total += t
            active += a
        if self.encoder:
            enc = self.encoder.n_layers * (4 * self.d_model * self.d_model
                                           + 2 * self.d_model * self.d_ff)
            # decoder cross-attention (one per decoder layer)
            enc += self.n_layers * 4 * self.d_model * self.d_model
            total += enc
            active += enc
        return total, active

    def embedding_params(self) -> int:
        n = self.padded_vocab * self.d_model
        return n if self.tie_embeddings else 2 * n


# --------------------------------------------------------------------------- #
# registry
# --------------------------------------------------------------------------- #
_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> Sequence[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    # import side-effect registers each architecture (whisper-tiny's
    # encoder-decoder is not ported yet: ``build_model`` refuses it)
    from . import (deepseek_v2_236b, granite_moe_1b_a400m,  # noqa
                   jamba_v0_1_52b, minicpm_2b, phi_3_vision_4_2b,
                   qwen2_0_5b, qwen2_7b, rwkv6_1_6b, stablelm_1_6b,
                   whisper_tiny)
