"""Production meshes (the reference's ``repro.launch.mesh``).

Single pod: 16 x 16 = 256 cards (data x model).
Multi-pod:  2 x 16 x 16 = 512 cards (pod x data x model); the 'pod' axis is
the cross-pod data-parallel axis (see repro_torch.distributed.compression
for the int8 gradient exchange that crosses it).

Functions, not module constants: importing this module never touches CUDA
state. A mesh is the visible cards (``cuda:0``, ``cuda:1``, ...); the CPU
only when the caller asks for it with ``device="cpu"``. ``device="meta"``
stands at every position: an abstract mesh of any size, whose tensors
have shapes and no storage (``launch.cells``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.aqp.executor import Mesh
from repro_torch.core.types import resolve_device


def _visible(device=None):
    """The devices a mesh is made of: every visible card, or the one
    ``device`` asked for by a type other than CUDA."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _make_mesh(shape, axes, device=None):
    devices = _visible(device)
    if devices[0].type == "meta":
        devices = devices * math.prod(shape)
    if len(devices) < math.prod(shape):
        raise ValueError(f"Number of devices {len(devices)} must be >= the "
                         f"product of mesh_shape {tuple(shape)}")
    return Mesh(tuple(devices[:math.prod(shape)]), tuple(axes), tuple(shape))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device)


def make_host_mesh(device=None):
    """Whatever this host has (tests / examples): (n_devices,) as 'data'."""
    n = len(_visible(device))
    return _make_mesh((n,), ("data",), device)
