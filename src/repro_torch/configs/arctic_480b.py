"""arctic-480b [moe]: 35L d7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128e top-2 + parallel dense residual FFN.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.models.config import ArchConfig, MoECfg


def config() -> ArchConfig:
    return ArchConfig(
        name="arctic-480b", family="moe", n_layers=35, d_model=7168,
        n_heads=56, n_kv=8, head_dim=128, d_ff=4864, vocab=32000,
        act="silu", rope_theta=1e4,
        moe=MoECfg(n_experts=128, top_k=2, dense_residual=True),
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="arctic-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, head_dim=16, d_ff=96, vocab=256,
        act="silu", param_dtype="float32", compute_dtype="float32",
        moe=MoECfg(n_experts=8, top_k=2, dense_residual=True,
                   capacity_factor=8.0),  # no drops: deterministic smoke semantics
    )
