"""The ``tpch_like`` fact table, drawn on the device from the run's seed.

A copy of the value distributions of ``repro_torch.aqp.workload.tpch_like``
(a denormalised TPC-H ``lineitem``), written in PyTorch so that the columns
are drawn on the card in a few large calls instead of on the host:

- ship_date ~ U(0, 2557) days, quantity ~ U(1, 50), discount ~ U(0, 0.1);
- returnflag ~ U{0..2}, linestatus ~ U{0..1}, nation ~ U{0..24};
- extendedprice = 900 * season(ship_date) * nation_mult[nation] *
  quantity / 25 + N(0, 40), season(d) = 1 + 0.3 sin(2 pi d / 365) +
  0.1 d / 2557, nation_mult ~ U(0.7, 1.3) per nation;
- revenue = extendedprice * (1 - discount).

The same seed and row count give the same columns: one
``torch.Generator`` on the device, drawn in a fixed order of fixed chunks.
"""
from __future__ import annotations

import math

import torch

F64 = torch.float64
CHUNK = 1 << 23  # rows a draw: bounds the temporaries to ~0.5 GB


def make_columns(config: dict, seed: int, device) -> dict:
    """``{"num": (N, 3) f64, "cat": (N, 3) int32, "measures": (N, 2) f64}``
    on ``device`` for ``config["rows"]`` rows."""
    n = int(config["rows"])
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    nation_mult = 0.7 + 0.6 * torch.rand(25, generator=gen, dtype=F64,
                                         device=device)
    num = torch.empty((n, 3), dtype=F64, device=device)
    cat = torch.empty((n, 3), dtype=torch.int32, device=device)
    measures = torch.empty((n, 2), dtype=F64, device=device)
    for s in range(0, n, CHUNK):
        m = min(CHUNK, n - s)
        u = torch.rand((m, 3), generator=gen, dtype=F64, device=device)
        date = u[:, 0] * 2557.0
        qty = 1.0 + 49.0 * u[:, 1]
        disc = 0.1 * u[:, 2]
        rf = torch.randint(0, 3, (m,), generator=gen, device=device)
        ls = torch.randint(0, 2, (m,), generator=gen, device=device)
        nation = torch.randint(0, 25, (m,), generator=gen, device=device)
        noise = 40.0 * torch.randn(m, generator=gen, dtype=F64, device=device)
        season = (1.0 + 0.3 * torch.sin(2.0 * math.pi * date / 365.0)
                  + 0.1 * (date / 2557.0))
        price = 900.0 * season * nation_mult[nation] * (qty / 25.0) + noise
        rows = slice(s, s + m)
        num[rows, 0] = date
        num[rows, 1] = qty
        num[rows, 2] = disc
        cat[rows, 0] = rf.to(torch.int32)
        cat[rows, 1] = ls.to(torch.int32)
        cat[rows, 2] = nation.to(torch.int32)
        measures[rows, 0] = price
        measures[rows, 1] = price * (1.0 - disc)
    return {"num": num, "cat": cat, "measures": measures}
