"""llama-3.2-vision-11b [vlm]: 40L d4096 32H (GQA kv=8) d_ff=14336
vocab=128256; gated cross-attention image layers every 5th layer; the vision
frontend is a STUB (input_specs provides precomputed patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.models.config import ArchConfig, CrossAttnCfg

N_IMG_TOKENS = 1600


def config() -> ArchConfig:
    return ArchConfig(
        name="llama-3.2-vision-11b", family="vlm", n_layers=40, d_model=4096,
        n_heads=32, n_kv=8, head_dim=128, d_ff=14336, vocab=128256,
        act="silu", rope_theta=5e5,
        cross_attn=CrossAttnCfg(period=5, n_ctx=N_IMG_TOKENS),
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="vision-smoke", family="vlm", n_layers=4, d_model=64,
        n_heads=4, n_kv=2, head_dim=16, d_ff=128, vocab=256, act="silu",
        cross_attn=CrossAttnCfg(period=2, n_ctx=16),
        param_dtype="float32", compute_dtype="float32",
    )
