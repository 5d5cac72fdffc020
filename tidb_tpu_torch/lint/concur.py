"""The lock-rank table the runtime lock-order witness enforces.

Every lock of the package, keyed ``module:Owner.attr`` (instance locks)
or ``module:GLOBAL`` (module locks).  A thread may only acquire locks in
STRICTLY increasing rank order — coarse/outer locks rank low, leaf locks
(metrics, per-trace span mutexes) rank high.  `util_concurrency`
reads it when TIDB_TPU_LOCKCHECK=1 turns the witness on.  The JAX
package's static lock-order lint over this table is not part of the
port.
"""

from __future__ import annotations

from typing import Dict

LOCK_RANKS: Dict[str, int] = {
    # ---- outermost: global dispatch / mesh construction -----------------
    # one statement's collectives across processes: held from the mesh
    # build to the last gather, around every dispatch of the statement
    "ops.collective:_PROGRAM_LOCK": 5,
    # resource-group admission sits IN FRONT of the dispatch door: its
    # registry mutex may be taken before DISPATCH_LOCK (never across it)
    "lifecycle.resgroup:ResourceGroupRegistry._mu": 8,
    "copr.parallel:DISPATCH_LOCK": 10,
    "copr.parallel:_MESH_LOCK": 20,
    # ---- session / DDL coarse state -------------------------------------
    "serving:_mu": 30,
    "session.domain:Domain._mu": 40,
    "coord:_PLANE_LOCK": 50,
    "lifecycle.scope:QueryScope._mu": 60,
    "session.priv:PrivManager._mu": 70,
    "catalog.catalog:Catalog._mu": 80,
    "statistics.handle:StatsHandle._mu": 90,
    "statistics.feedback:QueryFeedback._mu": 95,
    # the shard manager sits IN FRONT of the storage band: re-shard
    # attaches partition stores (rank 100/110) while holding it, and it
    # is never held across a dispatch
    "dataplane.shard:Dataplane._mu": 97,
    # leaf locks of the chaos-hardened RPC layer: held only around dict
    # bookkeeping, never across a dial, socket I/O, or another lock
    "dataplane.rpc:PeerPool._mu": 242,
    "dataplane.rpc:DataplaneServer._dedup_mu": 244,
    # ---- storage engine --------------------------------------------------
    "store.storage:BlockStorage._mu": 100,
    "store.blockstore:TableStore._mu": 110,
    "store.regions:RegionManager._mu": 120,
    "store.index:IndexManager._mu": 130,
    "store.deadlock:DeadlockDetector._mu": 140,
    "store.oracle:Oracle._lock": 150,
    # ---- serving / coordination plane -----------------------------------
    "serving.batcher:MicroBatcher._mu": 160,
    "coord.plane:Coordinator._save_io_mu": 170,
    "coord.plane:Coordinator._mu": 180,
    "coord.plane:LocalPlane._mu": 190,
    "coord.plane:WorkerPlane._mu": 195,
    "coord.plane:WorkerPlane._span_mu": 200,
    "copr.device_health:DeviceHealthRegistry._mu": 210,
    # ---- caches / layout -------------------------------------------------
    "copr.cache:ByteCapCache._mu": 220,
    "copr.cache:ProgramCache._mu": 225,
    "layout.autotuner:LayoutEngine._mu": 230,
    "layout.coldtier:_mu": 235,
    "native:_lib_mu": 240,
    # ---- observability / leaves ------------------------------------------
    "trace.slowlog:SlowQueryLog._mu": 250,
    "trace.slowlog:SlowQueryLog._io_mu": 255,
    "store.fault:FailpointRegistry._mu": 260,
    "util_memory:MemTracker._mu": 270,
    "executor.join:_STR_DICT_MU": 275,
    "trace.profiler:Profiler._mu": 280,
    "trace.recorder:_EXPORT_MU": 282,
    "trace.recorder:QueryTrace._mu": 285,
    # SLO AUTO rolling-window tracker: leaf, bucket arithmetic only
    "trace.slo:SloAutoWindows._mu": 287,
    "metrics:Registry._mu": 290,
}
