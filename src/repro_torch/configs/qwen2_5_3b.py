"""qwen2.5-3b [dense]: 36L d2048 16H (GQA kv=2) d_ff=11008 vocab=151936,
GQA with QKV bias, SwiGLU, RoPE. [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2.5-3b", family="dense", n_layers=36, d_model=2048,
        n_heads=16, n_kv=2, head_dim=128, d_ff=11008, vocab=151936,
        act="silu", qkv_bias=True, rope_theta=1e6,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen-smoke", family="dense", n_layers=3, d_model=64,
        n_heads=4, n_kv=2, head_dim=16, d_ff=128, vocab=256, act="silu",
        qkv_bias=True, param_dtype="float32", compute_dtype="float32",
    )
