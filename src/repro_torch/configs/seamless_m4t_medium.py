"""seamless-m4t-medium [audio]: enc-dec, 12L encoder + 12L decoder, d1024
16H (MHA kv=16) d_ff=4096 vocab=256206. The audio frontend is a STUB
(input_specs provides precomputed frame embeddings); shape cells split
seq_len as enc seq/2 + dec seq/2 (DESIGN.md). [arXiv:2308.11596; hf]"""
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="seamless-m4t-medium", family="audio", n_layers=12, d_model=1024,
        n_heads=16, n_kv=16, head_dim=64, d_ff=4096, vocab=256206,
        act="gelu_mlp", enc_dec=True, enc_layers=12,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="seamless-smoke", family="audio", n_layers=2, d_model=64,
        n_heads=4, n_kv=4, head_dim=16, d_ff=128, vocab=256,
        act="gelu_mlp", enc_dec=True, enc_layers=2,
        param_dtype="float32", compute_dtype="float32",
    )
