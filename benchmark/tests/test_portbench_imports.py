"""No module a run loads has the top-level name of the JAX stack or of
the JAX package: compared by the part before the first dot, whole, so
the port (`tidb_tpu_torch`) passes and `tidb_tpu` does not."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_by_top_level_name():
    names = ["tidb_tpu_torch", "tidb_tpu_torch.server", "tidb_tpu.copr",
             "tidb_tpu", "jax.numpy", "jaxlib", "flax.linen", "jaxtyping",
             "benchmark.harness", "torch"]
    assert harness.forbidden_modules(names) == [
        "flax.linen", "jax.numpy", "jaxlib", "tidb_tpu", "tidb_tpu.copr"]


def test_a_run_loads_no_forbidden_module():
    """A whole CPU run in a fresh process, then its sys.modules."""
    code = ("import json, runpy, sys; "
            "g = runpy.run_path('benchmark/tests/small_run.py'); "
            "g['main'](['sf10_q1q6_s3', '3', '1.0', '1']); "
            "from benchmark import harness; "
            "print(json.dumps(harness.forbidden_modules(sys.modules)))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("fault", ["forbidden", "forbidden_late"])
def test_the_run_refuses_a_forbidden_module(fault):
    """Loaded before the run starts, or only after the window has
    closed: either way no result."""
    p = subprocess.run([sys.executable, "benchmark/tests/small_run.py",
                        "sf10_q1q6_s3", "4", "1.0", "0", fault],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "tidb_tpu" in p.stderr and '"correct"' not in p.stdout
