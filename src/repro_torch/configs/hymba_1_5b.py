"""hymba-1.5b [hybrid]: 32L d1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
parallel attention + mamba heads per layer, ssm_state=16, 128 meta tokens,
3 full-attention layers (first/middle/last), rest sliding-window.
[arXiv:2411.13676; hf]"""
from repro_torch.models.config import ArchConfig, SSMCfg


def config() -> ArchConfig:
    return ArchConfig(
        name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
        n_heads=25, n_kv=5, head_dim=64, d_ff=5504, vocab=32001,
        act="silu", window=2048, meta_tokens=128,
        ssm=SSMCfg(kind="mamba", state=16, d_inner=1600),
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="hymba-smoke", family="hybrid", n_layers=6, d_model=64,
        n_heads=4, n_kv=2, head_dim=16, d_ff=128, vocab=256, act="silu",
        window=8, meta_tokens=4,
        ssm=SSMCfg(kind="mamba", state=4, d_inner=64),
        param_dtype="float32", compute_dtype="float32",
    )
