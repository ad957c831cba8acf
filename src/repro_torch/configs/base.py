"""Configuration dataclasses of the PyTorch port.

A field-for-field copy of the JAX package's configs (``repro/configs/base.py``):
the port imports nothing of that package, and the tests check with
``dataclasses.asdict`` that both sides agree for every registered name.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class H2ealConfig:
    """Hybrid static-dynamic sparse attention (paper §IV-A).

    static_sparsity: fraction of KV heads that are streaming heads.
    sink / local: token counts kept by streaming heads (and always attended
        by retrieval heads).
    page_size: contiguous KV tokens per page.
    select_budget: selected length for retrieval heads; top-k pages with
        k = select_budget // page_size.
    kv_budget: resident KV tokens per retrieval head before eviction
        (0 = no eviction).
    share_window: consecutive decode queries sharing one page selection.
    """

    enabled: bool = True
    static_sparsity: float = 0.5
    sink: int = 4
    local: int = 256
    page_size: int = 32
    select_budget: int = 4096
    kv_budget: int = 0
    share_window: int = 4

    @property
    def top_k_pages(self) -> int:
        return max(1, self.select_budget // self.page_size)


ATTN_FULL = "full"
ATTN_LOCAL_GLOBAL = "local_global"
MIXER_ATTENTION = "attention"
MIXER_MAMBA2 = "mamba2"
MIXER_SLSTM = "slstm"
MIXER_MLSTM = "mlstm"


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    shared_expert_ff: int = 0
    capacity_factor: float = 1.25

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64
    conv_dim: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 64


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    attn_pattern: str = ATTN_FULL
    local_window: int = 0
    local_global_ratio: int = 0
    mixer_pattern: Tuple[str, ...] = ()
    ffn_every_layer: bool = True
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    h2eal: H2ealConfig = field(default_factory=H2ealConfig)
    embed_frontend_stub: bool = False
    frontend_dim: int = 0
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    def mixer_for_layer(self, i: int) -> str:
        if self.mixer_pattern:
            return self.mixer_pattern[i % len(self.mixer_pattern)]
        return MIXER_ATTENTION

    def layer_has_ffn(self, i: int) -> bool:
        if self.d_ff == 0 and not self.moe.enabled:
            return False
        if self.ffn_every_layer:
            return True
        return self.mixer_for_layer(i) == MIXER_ATTENTION

    def layer_is_global_attn(self, i: int) -> bool:
        if self.attn_pattern != ATTN_LOCAL_GLOBAL:
            return True
        r = self.local_global_ratio
        return (i % (r + 1)) == r

    @property
    def attention_layers(self) -> Tuple[int, ...]:
        return tuple(i for i in range(self.num_layers)
                     if self.mixer_for_layer(i) == MIXER_ATTENTION)

    @property
    def has_attention(self) -> bool:
        return len(self.attention_layers) > 0

    def param_count(self) -> int:
        """Approximate parameter count N (the hbsim GEMM model reads it)."""
        hd = self.resolved_head_dim
        d = self.d_model
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for i in range(self.num_layers):
            mixer = self.mixer_for_layer(i)
            if mixer == MIXER_ATTENTION:
                n += (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                      + self.num_heads * hd * d)
            elif mixer == MIXER_MAMBA2:
                inner = self.ssm.expand * d
                # in_proj (z, x, B, C, dt) + out_proj + conv
                n += d * (2 * inner + 2 * self.ssm.state_dim) + inner * d
                n += inner * self.ssm.conv_dim
            elif mixer in (MIXER_SLSTM, MIXER_MLSTM):
                n += 4 * d * d + d * d  # gates + out proj (approx)
            if not self.layer_has_ffn(i):
                n += 2 * d
                continue
            if self.moe.enabled:
                n += self.moe.num_experts * 3 * d * self.d_ff
                n += d * self.moe.num_experts  # router
                if self.moe.shared_expert_ff:
                    n += 3 * d * self.moe.shared_expert_ff
            elif self.d_ff:
                n += 3 * d * self.d_ff  # swiglu
            n += 2 * d  # norms
        return n

    def active_param_count(self) -> int:
        """Active parameters a token (MoE: only the top_k experts count)."""
        if not self.moe.enabled:
            return self.param_count()
        inactive = (self.num_layers * (self.moe.num_experts - self.moe.top_k)
                    * 3 * self.d_model * self.d_ff)
        return self.param_count() - inactive


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    from repro_torch import configs  # noqa: F401  (populates REGISTRY)

    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A tiny same-family config for CPU tests (same rule as the JAX one)."""
    small = dict(
        num_layers=min(cfg.num_layers, 2 if not cfg.mixer_pattern else len(set(cfg.mixer_pattern))),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        local_window=64 if cfg.local_window else 0,
    )
    if cfg.moe.enabled:
        small["moe"] = MoEConfig(num_experts=4, top_k=2,
                                 shared_expert_ff=64 if cfg.moe.shared_expert_ff else 0,
                                 capacity_factor=0.0)
    if cfg.mixer_pattern:
        small["mixer_pattern"] = cfg.mixer_pattern[: max(2, min(4, len(cfg.mixer_pattern)))]
        small["num_layers"] = len(small["mixer_pattern"])
    small["h2eal"] = dataclasses.replace(
        cfg.h2eal, sink=2, local=16, page_size=8, select_budget=32, share_window=2
    )
    small.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **small)
