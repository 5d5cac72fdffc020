"""Every file BENCHMARK.json names is found by name, and the file keeps
to the benchmark contract's shape: names, units, bounds, paths, and the
cells, metrics and configurations each entry points at."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness, traffic

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["chips"] in (1, 4)


def test_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(cell):
    c = harness.load_cell(cell)
    assert c.config["tables"] and c.shapes
    for shape in c.shapes.values():
        assert callable(shape["module"].reference)
        for table, cols in shape["reads"].items():
            bits = next(t for t in c.config["tables"]
                        if t["name"] == table)["packed_bits"]
            assert set(cols) <= set(bits)
    assert (harness.HERE / "generators"
            / f"{c.config['generator']}.py").exists()
    for m in c.end_to_end + c.per_layer:
        assert callable(c.readers[m["name"]].read)
    # every cell reports setup_s, another end-to-end metric, a per-layer one
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and c.per_layer


def test_configs():
    for cfg in BENCH["configs"]:
        assert cfg["file"].startswith("benchmark/")
        assert LINE.match(cfg["source"]) and LINE.match(cfg["why"])
        data = traffic.load_json(ROOT / cfg["file"])
        assert data["source"] == cfg["source"]
        for key in cfg["reduced"]:
            assert NAME.match(key) and key in data
        assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    assert len({c["source"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_per_layer_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()


def test_samplers_draw_from_the_seed():
    c = harness.load_cell("sf10_q1q6_s3")
    a = traffic.streams(c.workload, c.shapes, 2**31 + 11, 40)
    b = traffic.streams(c.workload, c.shapes, 2**31 + 11, 40)
    assert a == b and len(a) == c.workload["streams"]
    assert a != traffic.streams(c.workload, c.shapes, 12, 40)
    # streams alternate the shapes, each from another one
    assert [s[0][0] for s in a] == ["q1", "q6", "q1"]
    assert [x[0] for x in a[0][:4]] == ["q1", "q6", "q1", "q6"]
    for st in a:
        for shape, sql, p in st:
            assert "{" not in sql and all(str(v) in sql for v in p.values())
