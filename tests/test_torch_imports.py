"""The torch port stands alone: no jax, nothing of the JAX package.

In a fresh interpreter (this one has imported jax already, through
conftest), importing `tidb_tpu_torch`, its MPP engine
(`tidb_tpu_torch.mpp`, with the join-tree engine), its serving path
(`tidb_tpu_torch.server`, `.serving.batcher`, `tidb_tpu_torch.__main__`),
its coordination and data planes (`.coord`, `.dataplane`), its static
analysis (every module of `tidb_tpu_torch.lint`) and the canonical
exchange programs (`.mpp.exchange`), creating a Domain and running Q6
must leave neither `jax` nor any `tidb_tpu.` module loaded; and a scan
of every source file under `tidb_tpu_torch/`, of the port's
multi-process workers and of `chip_smoke.py` finds no import of either
and no Pallas.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "tidb_tpu_torch"

_PROBE = r"""
import json, sys
import tidb_tpu_torch
import tidb_tpu_torch.mpp
import tidb_tpu_torch.mpp.jointree
import tidb_tpu_torch.server
import tidb_tpu_torch.server.server
import tidb_tpu_torch.serving.batcher
import tidb_tpu_torch.__main__
import tidb_tpu_torch.coord
import tidb_tpu_torch.dataplane
import tidb_tpu_torch.mpp.exchange
import tidb_tpu_torch.lint
import tidb_tpu_torch.lint.__main__
import tidb_tpu_torch.lint.baseline
import tidb_tpu_torch.lint.chaoscover
import tidb_tpu_torch.lint.concur
import tidb_tpu_torch.lint.kernelcheck
import tidb_tpu_torch.lint.metricnames
import tidb_tpu_torch.lint.plancheck
import tidb_tpu_torch.lint.purity
from tidb_tpu_torch import ops
ops.use_device("cpu")
from tidb_tpu_torch.tpch_data import LINEITEM_Q6, build_lineitem
s = build_lineitem(4096, regions=2, seed=7)
s.execute("set tidb_use_tpu = 1")
rows = s.query(LINEITEM_Q6)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "tidb_tpu"
             or m.startswith("tidb_tpu."))
print(json.dumps({"rows": len(rows), "bad": bad}))
"""


def test_fresh_process_loads_no_jax_and_no_jax_package():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["rows"] == 1
    assert res["bad"] == []


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


#: the port's multi-process workers and chip scripts stand alone as well
WORKERS = ("tests/torch_multihost_worker.py",
           "tests/torch_dataplane_worker.py", "tools/fleet_cards.py",
           "chip_smoke.py")


def test_sources_import_no_jax_package_and_no_pallas():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 50
    files += [ROOT / w for w in WORKERS]
    offenders = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "tidb_tpu") or "pallas" in mod:
                offenders.append(f"{f.relative_to(ROOT)}: {mod}")
    assert offenders == []


def test_missing_card_raises_instead_of_running_on_the_host():
    from tidb_tpu_torch import ops
    from tidb_tpu_torch.errors import DeviceUnavailableError

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(DeviceUnavailableError):
        ops.use_device("cuda")
