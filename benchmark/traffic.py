"""The one general traffic generator: it reads a workload file and the
statement shapes it names, and draws every stream's statements from the
seed.  Nothing in it knows a cell, a shape or a table by name."""

from __future__ import annotations

import datetime as _dt
import json
from pathlib import Path

import numpy as np


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def rng_for(seed: int, *salt: int) -> np.random.Generator:
    """An independent stream of draws for (`seed`, `salt`): any whole
    number is a seed, negative ones and those past 64 bits included."""
    return np.random.default_rng([int(seed) % (1 << 64), *salt])


def seed_for(seed: int, *salt: int) -> int:
    """A 64-bit seed for a torch.Generator, independent for each
    (`seed`, `salt`)."""
    return int(np.random.SeedSequence([int(seed) % (1 << 64), *salt])
               .generate_state(1, np.uint64)[0])


def draw_params(specs: list, rng: np.random.Generator) -> dict:
    """One draw of each sampler: `int` (uniform in lo..hi), `date`
    (uniform day in lo..hi, ISO dates), `choice` (one of `values`, a
    tuple of values bound to `names`)."""
    out = {}
    for s in specs:
        kind = s["kind"]
        if kind == "int":
            out[s["name"]] = int(rng.integers(s["lo"], s["hi"] + 1))
        elif kind == "date":
            lo = _dt.date.fromisoformat(s["lo"])
            span = (_dt.date.fromisoformat(s["hi"]) - lo).days
            out[s["name"]] = (lo + _dt.timedelta(
                days=int(rng.integers(0, span + 1)))).isoformat()
        elif kind == "choice":
            out.update(zip(s["names"],
                           s["values"][int(rng.integers(len(s["values"])))]))
        else:
            raise ValueError(f"unknown sampler kind {kind!r}")
    return out


def streams(workload: dict, shapes: dict, seed: int, per_stream: int,
            salt: int = 0) -> list:
    """`workload["streams"]` lists of `per_stream` (shape, sql, params).
    Stream i starts at shape i of the workload's list and alternates
    through it, so the streams do not all send one shape at once."""
    order = workload.get("order", "alternate")
    if order != "alternate":
        raise ValueError(f"unknown statement order {order!r}")
    names = workload["shapes"]
    out = []
    for i in range(int(workload["streams"])):
        rng = rng_for(seed, salt, i)
        stmts = []
        for k in range(per_stream):
            name = names[(i + k) % len(names)]
            params = draw_params(shapes[name]["params"], rng)
            stmts.append((name, shapes[name]["sql"].format(**params),
                          params))
        out.append(stmts)
    return out
