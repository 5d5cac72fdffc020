"""MPP exchange engine: device-resident partitioned shuffle joins.

The card-resident analog of TiFlash's MPP engine (ExchangeSender /
ExchangeReceiver hash shuffles feeding per-node hash joins).  Where the
reference ships rows between TiFlash nodes over gRPC, this engine keeps
both join sides resident on the card and runs partition, exchange and
local join as one sequence of torch ops — the join never touches the
host until its (row or partial-agg) output is read back.  The mesh's S
shards (`ops.mesh_devices`) each hold a slice of both sides; the
exchange is an all_to_all over them (the identity at S = 1), and the
bucket pack and the local join run on every shard.

Layering:

- exchange.py — device-side primitives: hash partition ids, static-
  capacity bucket packing with an overflow count, exchange / replicate
  (all_to_all / all_gather over the per-shard lists), key composition,
  sorted build and the two-pass join expansion.
- engine.py — run_mpp_join: eligibility, hot-tier column reuse, program
  cache, the shuffle -> broadcast -> host ladder (the `mpp/exchange`
  failpoint), host chunk assembly, scalar and grouped partial
  aggregation (computed string keys re-map through K1).
- jointree.py — run_mpp_jointree: multi-way rung ladders whose
  intermediate stays on the card between rungs.
- reader.py — MPPReaderExec / MPPTreeReaderExec, the root executors
  the planner's PhysMPPJoin / PhysMPPJoinTree build; they run the host
  hash join when the engine declines for a structural cause.
"""

from .engine import (  # noqa: F401
    MPPGroupedAggOverflow,
    MPPIneligible,
    MPPJoinSide,
    MPPJoinSpec,
    MPPPartitionOverflow,
    run_mpp_join,
)
from .reader import MPPReaderExec  # noqa: F401
