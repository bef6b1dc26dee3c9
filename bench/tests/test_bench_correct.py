"""The comparison that decides ``correct``, shown to fail: on the CPU, at a
size a test run holds, each cell's run with its control in the program's
place (``bench.kinds.aqp.control_of``), and with its timed path broken
underneath by each fault the cell can have (``bench.kinds.aqp.faults_of``),
reads ``correct`` false under the cell's own limits; the same run left
alone reads true. The cells are those of ``BENCHMARK.json`` and those held
out of it in ``bench/held_cells.json``.

The harness's look for a card is skipped (``harness.run`` with
``device="cpu"``); the rest of a run is driven whole: data, engine,
warm-up, the clients' window, the reference and the limits.
"""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402
from bench.kinds.aqp import faults_of  # noqa: E402
from bench.tests.test_bench_harness import tiny_base  # noqa: E402

BENCH = harness.benchmark()
HELD = harness.load_json(ROOT / "bench" / "held_cells.json")
ALL = dict(BENCH, configs=BENCH["configs"] + HELD["configs"],
           workloads=BENCH["workloads"] + HELD["workloads"])
CELLS = [w["name"] for w in ALL["workloads"]]
CASES = [(w["name"], mode, opts) for w in ALL["workloads"]
         for mode, opts in [("control", {"control": True})] + [
             (f, {"fault": f}) for f in faults_of(harness.load_json(
                 ROOT / "bench" / "configs" / f"{w['config']}.json"))]]


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return tiny_base(tmp_path_factory.mktemp("bench"), rows=20000, warmup=32)


def _checks(line):
    return {k: v["value"] for k, v in line["checks"].items()}


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(base, cell):
    line = harness.run(cell, 2 ** 31 + 77, 2.0, False, device="cpu",
                       bench=ALL, base=base)
    assert line["correct"], _checks(line)
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("cell,mode,opts", CASES,
                         ids=[f"{c}-{m}" for c, m, _ in CASES])
def test_the_control_and_each_fault_are_not_correct(base, cell, mode, opts):
    line = harness.run(cell, 2 ** 31 + 77, 2.0, False, device="cpu",
                       bench=ALL, base=base, **opts)
    assert not line["correct"], (mode, _checks(line))
