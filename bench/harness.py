"""The harness: one run of one cell of ``BENCHMARK.json``.

It finds everything by name: the cell in ``BENCHMARK.json``, its
configuration ``bench/configs/<config>.json``, whose ``kind`` names the
runner ``bench/kinds/<kind>.py``, its traffic ``bench/traffic/<traffic>
.json``, its limits ``bench/limits/<cell>.json`` and each metric's reader
``bench/metrics/<metric>.py``. A run prints one JSON line, the last of its
standard output; the numbers that decided ``correct``, each beside its
limit, are the last lines of its standard error and the last key of that
line.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(path: Optional[Path] = None) -> dict:
    return load_json(path or ROOT / "BENCHMARK.json")


def cell_parts(bench: dict, name: str, base: Path = BENCH):
    """The cell, its configuration, its traffic mix and its limits."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = load_json(base / "configs" / f"{cell['config']}.json")
    mix = load_json(base / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(base / "limits" / f"{name}.json")
    return cell, config, mix, limits


def metrics_of(bench: dict, cell: str, trace: bool):
    """The metric entries this cell reports in this kind of run."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", (cell,))]


def reader(name: str, base: Path = BENCH):
    """``read(run)`` of ``bench/metrics/<name>.py``."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def run(name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: Optional[float] = None,
        bench: Optional[dict] = None, base: Path = BENCH, **options) -> dict:
    """One run: the result line's object, with ``"checks"`` last."""
    bench = bench or benchmark()
    cell, config, mix, limits = cell_parts(bench, name, base)
    kind = importlib.import_module(f"bench.kinds.{config['kind']}")
    out = kind.run_cell(cell, config, mix, limits, seed, seconds, trace,
                        device=device, t_start=t_start, **options)
    metrics = {}
    for m in metrics_of(bench, name, trace):
        value = reader(m["name"], base)(out["run"])
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": bool(out["correct"]), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": out["device"]}
    if out.get("breakdown"):
        line["breakdown"] = out["breakdown"]
    line["info"] = out["info"]
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in out["checks"].items()}
    return line


def main(argv, t_start: float) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import torch

    bench = benchmark()
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(
        args.workload)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 3
    line = run(args.workload, args.seed, args.seconds, bool(args.trace),
               device="cuda", t_start=t_start, bench=bench)
    found = forbidden_modules()
    if found:
        print("loaded after the window: " + ", ".join(found),
              file=sys.stderr)
        return 4
    for k, c in line["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
