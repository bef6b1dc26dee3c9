"""phi3-mini-3.8b [dense]: 32L d3072 32H (MHA kv=32) d_ff=8192 vocab=32064,
RoPE SwiGLU. [arXiv:2404.14219; unverified]"""
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="phi3-mini-3.8b", family="dense", n_layers=32, d_model=3072,
        n_heads=32, n_kv=32, head_dim=96, d_ff=8192, vocab=32064, act="silu",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="phi3-smoke", family="dense", n_layers=3, d_model=64,
        n_heads=4, n_kv=4, head_dim=16, d_ff=128, vocab=256, act="silu",
        param_dtype="float32", compute_dtype="float32",
    )
