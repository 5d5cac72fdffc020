"""Shape-bucketed plan serving & query micro-batching.

The serving subsystem sits between the server's admission gate
and the coprocessor engines: its job is to make thousands of concurrent
clients share the small number of compiled XLA programs and device
dispatches the hardware actually needs.

Two mechanisms (ROADMAP "shape-bucketed plan serving + query
micro-batching"; grounding: TQP batches relational work into tensor
runtimes, Flare amortizes compilation across whole stages — here across
*queries*):

- **Shape buckets** (`buckets.py` + hooks in the copr engines): compiled
  programs are keyed on the query's SHAPE CLASS, not its literal shape
  or literal constants.  Row counts pad to next-power-of-two tile
  classes (masked rows), TopN budgets and probe key-sets pad to pow2,
  and predicate constants are HOISTED out of the program into runtime
  parameter vectors (`params.py`), so `l_shipdate <= '1998-09-02'` and
  `l_shipdate <= '1998-07-01'` run the SAME cached XLA program.
  Steady-state compile-cache hit rate becomes a function of query shape
  class.

- **Micro-batching** (`batcher.py`): identical-fingerprint point/agg
  statements arriving within a bounded window coalesce into ONE vmapped
  device dispatch over stacked parameter vectors; per-query results
  scatter back to each waiting connection.  Per-query QueryScope
  cancel/deadline is honored throughout — a killed member is masked
  out, never blocking the batch.

Config rides the sysvars `tidb_tpu_shape_buckets`,
`tidb_tpu_microbatch_window_ms` and `tidb_tpu_microbatch_max`; the
batcher and bucket policy are process-wide resources (like
max_connections), so a SET applies to the whole server.
"""

from __future__ import annotations

import threading
from typing import Dict

from .buckets import shape_bucket, topn_budget  # noqa: F401
from .params import hoist_conds  # noqa: F401
from ..util_concurrency import make_lock

#: sysvar names that feed the process-wide serving config
_SYSVARS = ("tidb_tpu_shape_buckets", "tidb_tpu_microbatch_window_ms",
            "tidb_tpu_microbatch_max")

_mu = make_lock("serving:_mu")
_CONFIG: Dict[str, float] = {
    # defaults mirror session/vars.py SYSVAR_DEFAULTS
    "shape_buckets": True,
    "microbatch_window_ms": 0.0,
    "microbatch_max": 32,
}


def config() -> Dict[str, float]:
    with _mu:
        return dict(_CONFIG)


def configure(**kw):
    """Override serving config directly (tests / embedders)."""
    with _mu:
        for k, v in kw.items():
            if k in _CONFIG:
                _CONFIG[k] = v


def refresh_from_vars(sess_vars):
    """Pull the serving sysvars out of a SessionVars overlay (called by
    SET; session values overlay globals, so the LAST writer wins — these
    knobs configure a process-wide resource)."""
    configure(
        shape_buckets=sess_vars.get_bool("tidb_tpu_shape_buckets"),
        microbatch_window_ms=float(
            sess_vars.get_int("tidb_tpu_microbatch_window_ms", 0)),
        microbatch_max=max(sess_vars.get_int("tidb_tpu_microbatch_max", 32),
                           1),
    )


def shape_buckets_enabled() -> bool:
    return bool(_CONFIG["shape_buckets"])


def microbatch_window_s() -> float:
    return float(_CONFIG["microbatch_window_ms"]) / 1000.0


#: adaptive-window shape: idle servers halve the configured window (a
#: lone statement should not sit out a pointless wait), pressure widens
#: it linearly with admission-queue depth (queued statements ARE the
#: batching opportunity) up to this cap
ADAPTIVE_MAX_FACTOR = 8.0
ADAPTIVE_IDLE_FACTOR = 0.5


def effective_window_s() -> float:
    """The ADAPTIVE micro-batch window: `tidb_tpu_microbatch_window_ms`
    scaled by live admission-queue pressure (the gauge the server's
    bounded admission maintains).  depth 0 → half the base window;
    each queued statement adds half a base window, capped at
    ADAPTIVE_MAX_FACTOR.  The effective value is published as the
    `serving_effective_window_ms` gauge on /metrics."""
    base = microbatch_window_s()
    if base <= 0.0:
        return 0.0
    from ..metrics import REGISTRY

    depth = REGISTRY.get("admission_queue_depth")
    factor = (ADAPTIVE_IDLE_FACTOR if depth <= 0
              else min(1.0 + depth / 2.0, ADAPTIVE_MAX_FACTOR))
    w = base * factor
    REGISTRY.set("serving_effective_window_ms", w * 1000.0)
    return w


def microbatch_max() -> int:
    return int(_CONFIG["microbatch_max"])


def try_run_microbatch(storage, req):
    """Distsql hook: serve `req` through the micro-batcher when eligible;
    None when ineligible or disabled (the caller falls through to the
    mesh / fan-out rungs).  Lifecycle errors (kill/timeout/shutdown) and
    runtime errors of the batched device program propagate."""
    if microbatch_window_s() <= 0.0:
        return None
    from .batcher import try_run_batched

    return try_run_batched(storage, req)
