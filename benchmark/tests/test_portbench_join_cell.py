"""The join cell `sf10_join_s3` beside the checks every cell gets: its
control (the plain reference with decimals as doubles) is not correct
on any seed, and on the card a small traced run reads its device and
join-route metrics with `correct` true (skips without a CUDA card, decided
inside the test)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import control, harness

ROOT = Path(__file__).resolve().parents[2]
CELL = "sf10_join_s3"


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 3])
def test_control_is_not_correct(seed):
    r = control.control_reading(harness.load_cell(CELL), seed, "cpu",
                                1 / 60, 16)
    assert r["statements"] > 0
    assert r["mismatched_values"] > 0 and not r["correct"]


@pytest.mark.cuda
def test_traced_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device metrics come from its trace")
    p = subprocess.run([sys.executable, "benchmark/tests/small_run.py", CELL,
                        "78", "2", "1", "cuda"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    m = r["metrics"]
    # at 1/60 of SF10 the host hash-joins customer and orders and
    # broadcasts the result into the lineitem scan: no join tree runs
    assert m["host_join_rows_per_stmt"]["value"] > 0
    assert m["join_tree_ms"]["value"] == 0
    assert 0 < m["hbm_roofline_pct"]["value"] < 100
