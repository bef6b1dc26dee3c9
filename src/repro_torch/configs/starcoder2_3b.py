"""starcoder2-3b [dense]: 30L d3072 24H (GQA kv=2) d_ff=12288 vocab=49152,
GQA, RoPE, non-gated GeLU MLP, biases. [arXiv:2402.19173; hf]"""
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-3b", family="dense", n_layers=30, d_model=3072,
        n_heads=24, n_kv=2, head_dim=128, d_ff=12288, vocab=49152,
        act="gelu_mlp", qkv_bias=True, rope_theta=1e5,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-smoke", family="dense", n_layers=3, d_model=64,
        n_heads=4, n_kv=2, head_dim=16, d_ff=128, vocab=256,
        act="gelu_mlp", qkv_bias=True,
        param_dtype="float32", compute_dtype="float32",
    )
