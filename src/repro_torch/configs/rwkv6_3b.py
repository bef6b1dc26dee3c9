"""rwkv6-3b [ssm] "Finch": 32L d2560 attention-free (data-dependent-decay
linear attention), d_ff=8960, vocab=65536, 40 heads x 64. [arXiv:2404.05892; hf]"""
from repro_torch.models.config import ArchConfig, SSMCfg


def config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-3b", family="ssm", n_layers=32, d_model=2560,
        n_heads=40, n_kv=40, head_dim=64, d_ff=8960, vocab=65536,
        act="silu", ssm=SSMCfg(kind="rwkv6"),
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-smoke", family="ssm", n_layers=3, d_model=64,
        n_heads=4, n_kv=4, head_dim=16, d_ff=128, vocab=256, act="silu",
        ssm=SSMCfg(kind="rwkv6", dec_lora=8),
        param_dtype="float32", compute_dtype="float32",
    )
