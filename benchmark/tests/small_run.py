"""One run of a cell at a small size, on the CPU or the card, with the
timed path optionally broken underneath, for the tests (the look for a
card skipped; everything else as `benchmark/run.py` runs it):

    python3 benchmark/tests/small_run.py <workload> <seed> <seconds> \
        <trace 0|1> [fault] [cuda]

Prints the result object as the last line.  Each fault breaks the
program, never the benchmark:

- `altered`: an answer altered where it is produced (the last value of
  every row the wire server renders);
- `half_rows`: half of every bulk-loaded batch left out, so every
  aggregate runs over the rest;
- `stale`: every statement answered as though its date literals were
  one fixed date (a step that keeps its first state: the parameters
  never reach the program);
- `forbidden`: a module named as the JAX package in `sys.modules` from
  the start, which the run must refuse;
- `forbidden_late`: the same module loaded only after the window has
  closed, while the answers are checked, which the run must refuse
  too."""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

#: the scale a test run holds: 25,000 orders, ~100 k lineitem rows
SCALE = 1 / 60


def _altered():
    from tidb_tpu_torch.server import protocol

    text_row = protocol.text_row

    def wrong(values):
        values = list(values)
        v = values[-1]
        if isinstance(v, bool) or v is None:
            pass
        elif isinstance(v, (int, float)):
            values[-1] = v + 1
        else:
            values[-1] = str(v) + "0"
        return text_row(values)

    protocol.text_row = wrong


def _half_rows():
    from tidb_tpu_torch import tpch_data

    load = tpch_data.load_arrays

    def half(session, table, arrays, dictionaries=None, db="test"):
        n = len(arrays[0]) // 2
        return load(session, table, [a[:n] for a in arrays], dictionaries, db)

    tpch_data.load_arrays = half


def _stale():
    from tidb_tpu_torch.session import Session

    execute = Session.execute

    def fixed(self, sql, *a, **k):
        if sql.lstrip().lower().startswith("select"):
            sql = re.sub(r"'\d{4}-\d{2}-\d{2}'", "'1995-03-15'", sql)
        return execute(self, sql, *a, **k)

    Session.execute = fixed


def _forbidden():
    import types

    sys.modules["tidb_tpu"] = types.ModuleType("tidb_tpu")


def _forbidden_late():
    from benchmark import harness

    compare = harness.compare

    def loads_then_compares(*a, **k):
        _forbidden()
        return compare(*a, **k)

    harness.compare = loads_then_compares


FAULTS = {"altered": _altered, "half_rows": _half_rows, "stale": _stale,
          "forbidden": _forbidden, "forbidden_late": _forbidden_late}


def main(argv) -> int:
    from benchmark import harness

    name, seed, seconds, trace = argv[0], int(argv[1]), float(argv[2]), argv[3]
    for fault in set(argv[4:]) - {"cuda"}:
        FAULTS[fault]()
    result = harness.run_cell(name, seed, seconds, trace == "1", T_START,
                              device="cuda" if "cuda" in argv[4:] else "cpu",
                              scale=SCALE)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
