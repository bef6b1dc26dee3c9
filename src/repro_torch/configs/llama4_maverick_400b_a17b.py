"""llama4-maverick-400b-a17b [moe]: 48L d5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128e top-1, interleaved (MoE every other layer) + shared
expert -> ~400B total / 17B active. [hf:meta-llama/Llama-4-Scout-17B-16E;
unverified]"""
from repro_torch.models.config import ArchConfig, MoECfg


def config() -> ArchConfig:
    return ArchConfig(
        name="llama4-maverick-400b-a17b", family="moe", n_layers=48,
        d_model=5120, n_heads=40, n_kv=8, head_dim=128, d_ff=8192,
        vocab=202048, act="silu", rope_theta=5e5,
        moe=MoECfg(n_experts=128, top_k=1, period=2, shared_expert=True),
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="llama4-smoke", family="moe", n_layers=4, d_model=64,
        n_heads=4, n_kv=2, head_dim=16, d_ff=96, vocab=256, act="silu",
        param_dtype="float32", compute_dtype="float32",
        moe=MoECfg(n_experts=8, top_k=1, period=2, shared_expert=True,
                   capacity_factor=8.0),  # no drops: deterministic smoke semantics
    )
