"""gemma2-2b [dense]: 26L d2304 8H (GQA kv=4) d_ff=9216 vocab=256000,
alternating local(4096)/global attention, GeGLU, attn/final logit softcaps,
pre+post RMSNorm. [arXiv:2408.00118; hf]"""
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="gemma2-2b", family="dense", n_layers=26, d_model=2304,
        n_heads=8, n_kv=4, head_dim=256, d_ff=9216, vocab=256000,
        act="gelu", attn_softcap=50.0, final_softcap=30.0,
        window=4096, layer_pattern="LG", post_norm=True,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="gemma2-smoke", family="dense", n_layers=4, d_model=64,
        n_heads=4, n_kv=2, head_dim=16, d_ff=128, vocab=256, act="gelu",
        attn_softcap=50.0, final_softcap=30.0, window=8,
        layer_pattern="LG", post_norm=True,
        param_dtype="float32", compute_dtype="float32",
    )
