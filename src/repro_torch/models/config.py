"""Architecture configuration and layer plans.

An ``ArchConfig`` describes one of the assigned architectures exactly
(dimensions from the public sources cited in the per-arch config modules).
``layer_plan()`` lowers it to a list of homogeneous *groups*: each group is a
tuple of per-layer ``LayerSpec``s (the scan-step body) plus a repeat count —
alternating-pattern archs (gemma2 local/global, llama4 dense/MoE) scan over
pattern *units* so every scanned body is shape-homogeneous.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    period: int = 1  # MoE every `period`-th layer (llama4: 2)
    shared_expert: bool = False  # llama4-style always-on expert
    dense_residual: bool = False  # arctic-style parallel dense FFN
    d_ff_expert: int = 0  # defaults to d_ff
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    kind: str  # 'rwkv6' | 'mamba'
    state: int = 16
    d_inner: int = 0  # defaults to d_model
    conv: int = 4  # mamba depthwise conv width
    dec_lora: int = 64  # rwkv6 data-dependent-decay LoRA width


@dataclasses.dataclass(frozen=True)
class CrossAttnCfg:
    period: int  # one cross-attn layer inserted per `period` layers
    n_ctx: int  # context (image / encoder) tokens


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    attn: str = "global"  # 'global' | 'local' | 'none'
    ssm: bool = False  # parallel (hymba) or sole (rwkv) sequence mixer
    moe: bool = False
    cross: bool = False  # cross-attention layer (vlm / decoder)
    causal: bool = True


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "silu"  # silu -> SwiGLU; gelu -> GeGLU; gelu_mlp -> plain MLP
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    window: int = 0  # local-attention window
    layer_pattern: str = "G"  # tiled over layers: 'G' global,'L' local
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    cross_attn: Optional[CrossAttnCfg] = None
    enc_dec: bool = False
    enc_layers: int = 0
    meta_tokens: int = 0  # hymba learnable prefix tokens
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    post_norm: bool = False  # gemma2: extra post-norms around blocks
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # mesh-dependent padding (set via with_tp)
    tp: int = 1

    # ---------------------------------------------------------------- derived
    def with_tp(self, tp: int) -> "ArchConfig":
        return dataclasses.replace(self, tp=tp)

    @property
    def heads_padded(self) -> int:
        return -(-self.n_heads // self.tp) * self.tp

    @property
    def kv_padded(self) -> int:
        """KV heads padded up to the smallest divisor of heads_padded >= n_kv
        (GQA needs heads_padded % kv == 0; e.g. hymba 25H/5kv -> 32H/8kv).
        KV projections shard over 'model' only when divisible by tp, else
        they are replicated — standard GQA practice."""
        hp = self.heads_padded
        for k in range(self.n_kv, hp + 1):
            if hp % k == 0:
                return k
        return hp

    @property
    def kv_sharded(self) -> bool:
        return self.kv_padded % self.tp == 0

    @property
    def d_ff_e(self) -> int:
        return (self.moe.d_ff_expert or self.d_ff) if self.moe else self.d_ff

    @property
    def n_params(self) -> float:
        """Total parameter count (for 6ND MODEL_FLOPS; unpadded, logical)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        att = d * self.n_heads * self.head_dim + 2 * d * self.n_kv * self.head_dim \
            + self.n_heads * self.head_dim * d
        gated = self.act in ("silu", "gelu")
        ffn_dense = (3 if gated else 2) * d * f
        total = v * d
        plans = (
            self.encoder_plan() + self.decoder_plan()
            if self.enc_dec
            else self.layer_plan()
        )
        for group, repeat in plans:
            for spec in group:
                per = 0.0
                if spec.attn != "none":
                    per += att
                if spec.cross:
                    per += att
                if spec.ssm:
                    s = self.ssm
                    di = s.d_inner or d
                    if s.kind == "rwkv6":
                        per += 4 * d * di + d * s.dec_lora + s.dec_lora * di + di * d
                    else:  # mamba
                        per += 2 * d * di + 2 * d * s.state + d * di + di * d
                if spec.moe:
                    m = self.moe
                    per += d * m.n_experts
                    per += m.n_experts * (3 if gated else 2) * d * self.d_ff_e
                    if m.shared_expert:
                        per += ffn_dense
                    if m.dense_residual:
                        per += ffn_dense
                elif spec.attn != "none" or spec.ssm:
                    per += ffn_dense
                total += per * repeat
        return float(total)

    @property
    def n_active_params(self) -> float:
        """Active parameters per token (MoE top-k instead of all experts)."""
        if not self.moe:
            return self.n_params
        m = self.moe
        inactive_frac = (m.n_experts - m.top_k) / m.n_experts
        gated = self.act in ("silu", "gelu")
        expert_params = 0.0
        for group, repeat in self.layer_plan():
            for spec in group:
                if spec.moe:
                    expert_params += repeat * m.n_experts * (3 if gated else 2) \
                        * self.d_model * self.d_ff_e
        return self.n_params - expert_params * inactive_frac

    # ------------------------------------------------------------------ plans
    def layer_plan(self) -> Tuple[Tuple[Tuple[LayerSpec, ...], int], ...]:
        """Homogeneous (unit, repeat) groups covering the decoder stack."""
        if self.name.startswith("hymba"):
            # 3 full-attention layers (first/middle/last), rest sliding-window,
            # every layer with a parallel mamba branch [arXiv:2411.13676].
            n = self.n_layers
            mid = n // 2
            loc = lambda: LayerSpec(attn="local", ssm=True)
            glob = lambda: LayerSpec(attn="global", ssm=True)
            return (
                ((glob(),), 1),
                ((loc(),), mid - 1),
                ((glob(),), 1),
                ((loc(),), n - mid - 2),
                ((glob(),), 1),
            )
        if self.ssm and self.ssm.kind == "rwkv6":
            return (((LayerSpec(attn="none", ssm=True),), self.n_layers),)
        if self.cross_attn:
            p = self.cross_attn.period
            unit = tuple(
                [LayerSpec(attn="global", cross=True)]
                + [LayerSpec(attn="global")] * (p - 1)
            )
            assert self.n_layers % p == 0
            return ((unit, self.n_layers // p),)
        if self.moe and self.moe.period > 1:
            p = self.moe.period
            unit = tuple(
                [LayerSpec(attn="global")] * (p - 1) + [LayerSpec(attn="global", moe=True)]
            )
            assert self.n_layers % p == 0
            return ((unit, self.n_layers // p),)
        if self.moe:
            return (((LayerSpec(attn="global", moe=True),), self.n_layers),)
        pattern = self.layer_pattern
        if pattern != "G":
            unit = tuple(
                LayerSpec(attn="local" if ch == "L" else "global") for ch in pattern
            )
            assert self.n_layers % len(pattern) == 0
            return ((unit, self.n_layers // len(pattern)),)
        return (((LayerSpec(attn="global"),), self.n_layers),)

    def encoder_plan(self):
        assert self.enc_dec
        return (((LayerSpec(attn="global", causal=False),), self.enc_layers),)

    def decoder_plan(self):
        """Enc-dec decoder: self-attention + cross-attention per layer."""
        assert self.enc_dec
        return (((LayerSpec(attn="global", cross=True),), self.n_layers),)
