"""The plain references against the port's rows over the wire, on the
CPU at ~100 k lineitem rows: a whole run of each cell (set-up, the
window driven from the client process, the check) comes out correct,
and comes out not correct with the timed path broken underneath."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def run(cell, fault=None, trace=0, seed=20261018):
    p = subprocess.run([sys.executable, "benchmark/tests/small_run.py", cell,
                        str(seed), "1.5", str(trace)] + ([fault] if fault else []),
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_references_equal_the_port_over_the_wire(cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    want = {m["name"] for m in harness.load_cell(cell).end_to_end}
    assert set(r["metrics"]) == want
    assert r["checks"] == {"mismatched_values": {"value": 0, "limit": 0},
                           "unanswered": {"value": 0, "limit": 0}}
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["altered", "half_rows", "stale"])
def test_a_broken_program_is_not_correct(cell, fault):
    r = run(cell, fault)
    assert not r["correct"]
    assert r["checks"]["mismatched_values"]["value"] > 0


def test_traced_run_reports_the_front_end():
    """Off the card a traced run reads the program's spans and counters;
    the device readers find nothing and stay out of the line."""
    r = run("sf10_q1q6_s3", trace=1)
    assert r["correct"]
    assert {"frontend_ms", "plan_cache_hit_pct"} <= set(r["metrics"])
    assert not {"rows_per_s", "device_idle_pct"} & set(r["metrics"])
    assert r["metrics"]["frontend_ms"]["value"] > 0
