"""On the card: a small traced run of each cell reads its device
metrics from the profiler's trace, with `correct` true.  Skips without
a CUDA card (decided inside the test)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["sf10_q1q6_s3"])
def test_traced_run_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device metrics come from its trace")
    p = subprocess.run([sys.executable, "benchmark/tests/small_run.py", cell,
                        "77", "2", "1", "cuda"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    for m in ("device_idle_pct", "hbm_roofline_pct", "launches_per_stmt",
              "frontend_ms"):
        assert m in r["metrics"], r["metrics"]
    assert 0 < r["metrics"]["hbm_roofline_pct"]["value"] < 100
    assert r["breakdown"]["device_ops"] and r["breakdown"]["idle_gaps"]
