"""Assigned-architecture registry: ``get(name)`` / ``get_smoke(name)``.

The reference's table, with the ten arch modules imported by name (the
reference loads them through ``importlib``), so the port's dead-code rule
sees every one of them imported.
"""
from repro_torch.configs import (
    arctic_480b,
    gemma2_2b,
    hymba_1_5b,
    llama3_2_vision_11b,
    llama4_maverick_400b_a17b,
    phi3_mini_3_8b,
    qwen2_5_3b,
    rwkv6_3b,
    seamless_m4t_medium,
    starcoder2_3b,
)

ARCHS = {
    "arctic-480b": arctic_480b,
    "llama4-maverick-400b-a17b": llama4_maverick_400b_a17b,
    "qwen2.5-3b": qwen2_5_3b,
    "gemma2-2b": gemma2_2b,
    "phi3-mini-3.8b": phi3_mini_3_8b,
    "starcoder2-3b": starcoder2_3b,
    "llama-3.2-vision-11b": llama3_2_vision_11b,
    "rwkv6-3b": rwkv6_3b,
    "seamless-m4t-medium": seamless_m4t_medium,
    "hymba-1.5b": hymba_1_5b,
}


def _module(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get(name: str):
    return _module(name).config()


def get_smoke(name: str):
    return _module(name).smoke()


def names():
    return list(ARCHS)
