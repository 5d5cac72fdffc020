"""Smoke run of the torch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the sources in this checkout
(K1 `remap_codes` and K2 `unpack_codes`, one nvcc each, concurrently;
ptxas's registers and spills per kernel are printed), holds each against
its plain PyTorch version on the card and times it (K2 in both forms:
bare, and with the cold tier's range decode fused in by an int32 or
int64 bias, beside the unfused sequence it replaces), then drives the
port's paths end to end from SQL over a synthetic lineitem:

- at SF10 (60 M rows), hot (every column resident) and cold (the
  hot-tier cap below the table's wire bytes, so the packable columns
  live bit-packed on the card and unpack through K2): TPC-H Q1 and Q6
  (dense aggregation), `ck1` (Q1 grouped by a computed string key,
  lower(l_returnflag): sort mode, K1 with an int32 mapping) and `ck2`
  (a Q6-shaped query grouped by ascii(l_linestatus): K1 with an int64
  mapping); hot only, `sa` (sort mode over ~100 k l_orderkey groups),
  `tn` (a two-key TopN) and `mf` (a filter of a few hundred rows);
- at SF1 (6 M rows), TPC-H Q18's inner aggregation `q18i` (~1.5 M
  groups, beyond the sort-mode budget of 2**17 groups per dispatch) and
  `q18p`, the same with Q1's ship-date filter: both overflow the
  budget; q18p takes the peel rung (its scan and filter stay on the
  card, the aggregation runs on the host), q18i, whose device head
  would be a bare scan, leaves the fused program for the per-region
  rung, as the JAX package does;
- joins: Domain T, the 8-table TPC-H generator at SF1's lineitem size
  (6 M rows): the three-way TPC-H `q3` and the semi join `sj`, whose
  lineitem scans carry a runtime join filter (JoinProbe) on the card;
  Domain J, the Q3 pair of `build_q3_tables` (16,777,216 lineitem rows,
  131,072 orders), hot and cold: `q3p` (TPC-H Q3's pair shape, a
  broadcast lookup join whose group keys the join key determines) and
  `q3d` (grouped by a payload key and a scan key, l_discount, which
  unpacks through K2 in the cold leg); and `pt`, three statements over
  orders whose table reader runs over six disjoint handle ranges, more
  than the fused program's range slots: the per-region rung runs them
  tile by tile on the card; `ptl`, the same over Domain J's lineitem
  (16 tiles, six spans that cross tile and region edges), before and
  after deleting rows inside the spans;
- the MPP exchange engine (one card, S = 1): `mA10`, the SF10 hot
  lineitem joined with a 15 M-row orders table without a primary key
  (a shuffle join), grouped by `lower(o_orderpriority)` (grouped
  partials merged on the card, K1 re-mapping the key over the joined
  rows), against numpy, with the peak device memory; on Domain T, `mC`
  (a non-unique build key, scalar partials) and `mE` (rows), and the
  join trees of TPC-H q3, q5, q10 and the semi join (`t3`, `t5`, `t10`,
  `tsj`), against the port's host engine (and numpy for t3 and tsj).
  The q3 and sj cells run with `tidb_allow_mpp = 0`, so the runtime-filter
  path is still driven; each MPP cell must keep its rung and move no
  fallback or overflow counter;
- the serving path `srv` on Domain T: the port's MySQL server in this
  process (`tidb_tpu_torch.server.MySQLServer`) and 32 concurrent wire
  connections of 8 statements each (this script carries its own
  protocol-4.1 client), round-robin over a scalar aggregate by supplier,
  a grouped aggregate over a 30-day ship window and a ~40-row filter by
  part, literals from default_rng(6); one pass solo, one with
  `SET GLOBAL tidb_tpu_microbatch_window_ms = 5`, where statements of
  one shape coalesce into one batched per-tile program per tile
  (serving/batcher.py).  Rows of both passes against numpy; every
  batched statement must run in a batch (`serving_batched_stmts_total`)
  on `engine:microbatch`, batches must hold more than one member, and
  the solo pass must move no batch counter.  Statements/s, p50/p99
  latency and the mean batch size are printed for each pass;
- the mesh (S > 1): MESH_S = 4 positions on the one card
  (`ops.use_device("cuda", shards=4)`): the SF10 cells Q1, Q6, ck1, tn
  and the filter `mf`, hot and cold (K1 and K2 on per-shard inputs),
  each against numpy and its S = 1 rows; failover on the card (position
  3 fails once during Q1: the mesh rebuilds over 3 positions, nothing
  of position 3 stays cached, and after the cooldowns expire Q1 runs on
  4 again); mA10 at 4 and at 2 positions, with the peak device memory
  of each (the static exchange capacities hold 4x and 2x S = 1's
  slots); Domain T's t3, t10 and tsj; and fl_dense, 5 runs
  bit-identical;
- fixed-order float sums: a table of 16,777,216 doubles grouped by 100
  keys (past the 32 groups whose sums unroll), in dense mode (a stored
  key) and in sort mode (a computed key, `k % 100`), 5 runs each: the
  rows must be bit-identical across runs and equal math.fsum per group
  after tests/test_tpch.py's `_norm`; then the dense shape with four
  literals in one micro-batch (4 x 100 float segments) against its solo
  rows after `_norm`;
- the fleet, processes on the one card, each spawned as `chip_smoke.py
  --fleet-worker ...` and regenerating its data from the same seeds:
  `mh`, 2 processes x 2 positions in one torch.distributed group (gloo,
  as NCCL refuses two ranks on one device): SF10 Q1, Q6 and ck1 hot and
  cold (K1 and K2 on each process's per-shard inputs, held against
  their plain versions there), Domain T's t3 and tsj (the exchange's
  all_to_all between processes) and fl_dense x 5, every process's rows
  against numpy and the S = 1 rows above, walls and peak device memory
  a process beside S = 1 and the in-process mesh; `dp`, the
  coordinator in this process and 2 data-plane members on the card,
  the SF10 lineitem sharded (RF = 1): rounds of Q1, Q6 and ck1 hot and
  cold through the data plane (every partition fragment on the card,
  no bypass, rows against numpy), then SIGKILL of member 1: the epoch
  bumps, member 0 re-shards from the persisted blocks and answers with
  parity; the time to recover from the kill.

- the lint phase: the kernel family of `python -m tidb_tpu_torch.lint`
  on the card (`tidb_tpu_torch/lint/kernelcheck.py`): every canonical
  program (the per-tile programs, the whole-fragment mesh programs hot
  and cold, the MPP exchange, tree and grouped programs, the batched
  program, K1 and K2) runs once on canonical inputs under the op
  recorder, against the `cuda` section of the port's lint baseline: a
  failed program, an op sequence that moves with operand values or
  context, a ProgramCache entry or nvcc build on a re-run of the corpus,
  int64 ops past the baseline, or K1/K2 unequal to their plain versions
  fails the run; each program's ops, int64 ops and K1/K2 launches are
  printed.

The fused program's rows per dispatch chunk are fixed at CHUNK_ROWS
(`TIDB_TPU_DISPATCH_CHUNK_ROWS`): the port's own budget learns rows/ms
from every earlier dispatch of the process, so each cell's chunking
would depend on the cells run before it.

Rows are checked against a plain numpy computation over the generator's
own arrays, and Q1/Q6 at SF1 against the port's host engine.  Each
cell's kernel launches are counted from zero; every input the path
hands K1 and K2 is recorded, and each kernel is held against its plain
version and timed again on those very inputs: the `kernels` line
reports the input (and for K2 the form) the path launched most, and
the fleet workers' launches and inputs beside it.

Output: human-readable lines, then a `{"kernels": [...]}` JSON line, the
card's name and power limit, and as the last line
`{"ok": true, "device": {...}}`.  Exits non-zero (with no result) when
no CUDA device is present, when the port is not importable, or when any
phase fails.

    python3 chip_smoke.py [--profile | --lint-only]

`--lint-only` builds the kernels and runs the lint phase alone.
`--profile` adds a torch.profiler breakdown of one steady Q1, Q6, ck1
and ck2 in each deployment, of `sa` and `tn` hot, and of the join,
MPP and per-tile cells (mA10; q3, sj, mC, mE, t3, t5, t10, tsj; q3p
and q3d hot and cold; pt, ptl) and the float cells, the device time
and idle share of each `srv` pass, with the kernels and host operators
that take the most time and the device time of the named range
`mpp.pack` (the exchange's bucket pack).
"""

from __future__ import annotations

import gc
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

SF10_ROWS = 60_000_000
SF1_ROWS = 6_000_000
KERNEL_ROWS = 64 << 20   # 64 Mi rows per kernel call, the scale of a scan
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
SEED = 7
#: rows per dispatch chunk of the fused program: SF10's 60 M rows in two
#: (52,428,800 + 7,571,200), every other cell in one
CHUNK_ROWS = 52_428_800

#: the second slice's cells, in the order they run
CK1 = ("select lower(l_returnflag), l_linestatus, sum(l_quantity),"
       " sum(l_extendedprice * (1 - l_discount)), avg(l_discount), count(*)"
       " from lineitem where l_shipdate <= '1998-09-02'"
       " group by lower(l_returnflag), l_linestatus")
CK2 = ("select ascii(l_linestatus), count(*),"
       " sum(l_extendedprice * l_discount) from lineitem"
       " where l_shipdate >= '1994-01-01' and l_shipdate < '1995-01-01'"
       " group by ascii(l_linestatus)")
SA = ("select l_orderkey, sum(l_quantity), count(*) from lineitem"
      " where l_orderkey <= 100000 group by l_orderkey")
TN = ("select l_orderkey, l_extendedprice from lineitem"
      " where l_shipdate >= '1995-03-15'"
      " order by l_extendedprice desc, l_orderkey limit 10")
#: a filter statement of a few hundred rows at SF10 (the fused mask and
#: the host gather of the selected handles), at S = 1 and on the mesh
MF = ("select l_orderkey, l_extendedprice, l_discount from lineitem"
      " where l_extendedprice < 901.00")
Q18I = ("select l_orderkey, sum(l_quantity) from lineitem"
        " group by l_orderkey having sum(l_quantity) > 300")
Q18P = ("select l_orderkey, sum(l_quantity) from lineitem"
        " where l_shipdate <= '1998-09-02'"
        " group by l_orderkey having sum(l_quantity) > 300")

#: the third slice's cells: Domain J, the Q3 pair of `build_q3_tables`
#: (lineitem at bench.py's Q3 join-bench size; orders cut to n_li/128 so
#: q3p's ~78 k groups stay under the 2**17 sort budget), and Domain T,
#: the 8-table generator at TPC-H SF1's lineitem size
J_LINEITEM = 16_777_216
J_ORDERS = 131_072
J_SEED = 11
T_SCALE = 750
T_SEED = 1234
Q3D = ("select o_shippriority, l_discount, count(*),"
       " sum(l_extendedprice * (1 - l_discount))"
       " from lineitem, orders"
       " where l_orderkey = o_orderkey and o_orderdate < '1995-03-15'"
       " and l_shipdate > '1995-03-15'"
       " group by o_shippriority, l_discount")
SJ = ("select count(*) from lineitem where l_orderkey in"
      " (select o_orderkey from orders where o_orderdate < '1994-09-01')")
#: pt: six disjoint o_orderkey spans [lo, hi) (o_orderkey == handle),
#: about half of orders, and the predicate that names them
PT_SPANS = [(1_000, 12_000), (20_000, 31_000), (40_000, 52_000),
            (60_000, 71_000), (80_000, 92_000), (100_000, 111_000)]
PT_RANGES = "(" + " or ".join(f"o_orderkey between {lo} and {hi - 1}"
                              for lo, hi in PT_SPANS) + ")"
PT_CUT = "1993-12-13"  # the first 16 of 800 order dates: ~1 % of orders
PT = [("pt_agg", "select o_shippriority, count(*), min(o_orderdate),"
                 f" max(o_orderdate) from orders where {PT_RANGES}"
                 " group by o_shippriority"),
      ("pt_topn", f"select o_orderkey, o_orderdate from orders where"
                  f" {PT_RANGES} order by o_orderdate desc limit 10"),
      ("pt_filter", "select o_orderkey, o_orderdate, o_shippriority from"
                    f" orders where {PT_RANGES}"
                    f" and o_orderdate < '{PT_CUT}'")]
#: ptl: the per-tile rung over Domain J's lineitem (handle == row, 16
#: tiles of TILE = 2**20 rows, 8 regions of two tiles): six disjoint
#: [lo, hi) row spans, ~6 M rows, each crossing a tile or a region edge;
#: no SQL predicate names them, so the rows are held to numpy only
PTL_SPANS = [(1_000_000, 1_100_000), (2_000_000, 3_200_000),
             (4_190_000, 4_200_000), (6_000_000, 9_000_000),
             (11_000_000, 11_600_000), (15_700_000, J_LINEITEM)]
PTL_CUT = 194_100  # l_extendedprice in cents: ~1 % of 90,000..10,500,000
PTL = [("ptl_agg", "select l_discount, count(*), min(l_shipdate),"
                   " max(l_shipdate), sum(l_extendedprice) from lineitem"
                   " group by l_discount"),
       ("ptl_topn", "select l_extendedprice, l_shipdate from lineitem"
                    " order by l_extendedprice desc limit 10"),
       ("ptl_filter", "select l_orderkey, l_extendedprice, l_shipdate"
                      " from lineitem where l_extendedprice <"
                      f" {PTL_CUT // 100}.{PTL_CUT % 100:02d}")]
#: the orders whose lineitem rows are deleted before ptl's second pass
#: (~8 k rows over every tile)
PTL_DELETE = tuple(range(7, J_ORDERS, 2048))

#: the fourth slice's cells: the MPP exchange engine.  mA10 joins the
#: SF10 lineitem with an `orders` table of 15,000,001 rows that has no
#: primary key (o_orderkey covers lineitem's l_orderkey domain [1,
#: n/4 + 2), o_orderpriority one of TPC-H's five priorities drawn from
#: M_SEED): a shuffle join (the build side is past the broadcast cap and
#: not unique to the planner), grouped by a computed string key whose
#: codes K1 re-maps over the joined rows
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
M_SEED = 5
MA10 = ("select lower(o_orderpriority), count(*),"
        " sum(l_extendedprice * (1 - l_discount))"
        " from lineitem join orders on l_orderkey = o_orderkey"
        " where l_shipdate > '1995-03-15' group by lower(o_orderpriority)")
#: Domain T's MPP cells: a non-unique build key (4 partsupp rows a part)
#: under scalar partials (mC) and in rows mode (mE), and the join trees
#: of TPC-H q3, q5, q10 and the semi join (t3, t5, t10, tsj)
MC = ("select count(*), sum(ps_supplycost), sum(l_quantity),"
      " min(l_shipdate), max(ps_availqty) from lineitem join partsupp"
      " on l_partkey = ps_partkey where l_quantity <= 10")
ME = ("select l_orderkey, l_quantity, ps_availqty from lineitem"
      " join partsupp on l_partkey = ps_partkey"
      " where l_quantity < 1.25 and l_shipdate < '1993-01-01'")
#: counters that move only when an MPP cell leaves its rung
MPP_FAILURES = ("mpp_fallback_total", "mpp_partition_overflow_total",
                "mpp_grouped_agg_overflow_total")

#: the serving phase `srv`: Domain T over the MySQL wire, SRV_CONNS
#: concurrent connections of SRV_STMTS statements each, round-robin over
#: three shapes with literals from default_rng(SRV_SEED); one pass solo
#: (no batching window), one with the window at SRV_WINDOW_MS
SRV_CONNS = 32
SRV_STMTS = 8
SRV_SEED = 6
SRV_WINDOW_MS = 5
SRV_SHAPES = {
    # scalar dense aggregation
    "a": ("select count(*), sum(l_quantity), sum(l_extendedprice) from"
          " lineitem where l_suppkey = {}"),
    # grouped dense aggregation over a 30-day ship window
    "b": ("select l_returnflag, l_linestatus, count(*), sum(l_extendedprice)"
          " from lineitem where l_shipdate >= '{}' and l_shipdate < '{}'"
          " group by l_returnflag, l_linestatus"),
    # filter (~40 rows)
    "c": "select l_orderkey, l_quantity from lineitem where l_partkey = {}",
}
SRV_COUNTERS = ("serving_batches_total", "serving_batched_stmts_total",
                "serving_batch_errors_total")

#: the mesh phase: S positions on the one card (`ops.use_device("cuda",
#: shards=MESH_S)`); mA10 runs at each of MESH_MA10_S: at 4 its static
#: exchange capacities hold 4x S = 1's slots, at 2 twice (PERF.md)
MESH_S = 4
MESH_MA10_S = (4, 2)
MESH_T = ("t3", "t10", "tsj")

#: the float phase: FL_ROWS doubles over FL_GROUPS keys (above the
#: unrolled sums' 32 groups), each statement run FL_RUNS times
FL_ROWS = 16_777_216
FL_GROUPS = 100
FL_SEED = 8
FL_RUNS = 5
FL_DENSE = "select k, count(*), sum(x) from fl group by k"
FL_SORT = ("select k % 100, count(*), sum(x) from fl"
           " group by k % 100")
FL_BATCH = ("select k, count(*), sum(x) from fl where x < {}"
            " group by k")
FL_BATCH_CUTS = (0.125, 0.375, 0.625, 0.875)
#: the reduction alone at the size of an SF10 lineitem scan
FL_OP_ROWS = 59_986_052


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def time_turns(fns: dict, reps: int = 25, flush=None) -> dict:
    """Median milliseconds of each of `fns` (name -> callable), timed in
    turns within one call: one warm-up each, then `reps` rounds that run
    every function once, in order and then reversed on alternate rounds
    (A B, B A, ...), each between CUDA events with L2 flushed before."""
    import torch

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    order = list(fns)
    for rep in range(reps):
        for name in (order if rep % 2 == 0 else order[::-1]):
            if flush is not None:
                flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(t) for name, t in times.items()}


def time_cuda(fn, reps: int = 25, flush=None) -> float:
    """Median milliseconds of `fn` alone (`time_turns` with one
    function)."""
    return time_turns({"ms": fn}, reps, flush)["ms"]


def k2_out(bias) -> str:
    """K2's output dtype: uint8 bare, the bias's dtype fused."""
    return "uint8" if bias is None else str(bias.dtype)[6:]


def k2_tag(bits: int, n: int, bias) -> str:
    return f"bits={bits} out={k2_out(bias)} n={n}"


def k2_times(r: dict) -> str:
    unfused = (f", unfused {r['unfused_ms']:.4f} ms" if "unfused_ms" in r
               else "")
    return (f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms"
            f"{unfused}, bound {r['bound_ms']:.4f} ms")


def check_k2(packed, bits: int, n: int, bias=None) -> int:
    """K2 on one input against its plain version: the same dtype, shape
    and values exactly (raises otherwise); returns max |err| (0)."""
    import torch

    from tidb_tpu_torch.copr.cuda import unpack_codes, unpack_codes_plain

    got = unpack_codes(packed, bits, n, bias=bias)
    want = unpack_codes_plain(packed, bits, n, bias=bias)
    torch.cuda.synchronize()
    tag = k2_tag(bits, n, bias)
    if got.shape != (n,) or got.dtype != want.dtype:
        raise AssertionError(f"unpack_codes {tag}: shape "
                             f"{tuple(got.shape)} {got.dtype}")
    err = int((got.to(torch.int64) - want.to(torch.int64))
              .abs().max().item())
    if err != 0 or not torch.equal(got, want):
        raise AssertionError(f"unpack_codes {tag}: max |err| {err}")
    return err


def time_k2(packed, bits: int, n: int, flush, bias=None) -> dict:
    """K2 on one input timed in turns with its plain version and, for the
    fused form, with the sequence the fusion replaces (the bare kernel,
    then the widening copy, then the add); the bound is the bytes the
    fused pass must move (n*bits/8 read, n*sizeof(out) written)."""
    from tidb_tpu_torch.copr.cuda import unpack_codes, unpack_codes_plain

    fns = {"ms": lambda: unpack_codes(packed, bits, n, bias=bias),
           "plain_ms": lambda: unpack_codes_plain(packed, bits, n,
                                                  bias=bias)}
    if bias is not None:
        fns["unfused_ms"] = (lambda: unpack_codes(packed, bits, n)
                             .to(bias.dtype) + bias)
    r = time_turns(fns, flush=flush)
    size = 1 if bias is None else bias.element_size()
    nbytes = n * bits // 8 + n * size
    r.update({"bits": bits, "n": n, "bytes": nbytes,
              "out_dtype": k2_out(bias),
              "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
    return r


#: K2's forms: (bits, bias value and dtype or None); negative biases
#: among them, and 8 bits only with a bias (bare it launches nothing)
K2_FORMS = ([(b, None) for b in (1, 2, 4)]
            + [(b, (-1_000_000_007, "int32")) for b in (1, 2, 4, 8)]
            + [(b, (1234, "int64")) for b in (1, 2, 4)]
            + [(8, (-(1 << 40), "int64"))])
#: a row count that is a multiple of neither 16 (a thread's rows per
#: step) nor 512 (a warp's), so the kernel's ragged end runs
K2_RAGGED = 16 * 65536 + 8


def kernel_phase():
    """K2 against its plain version on the card, bare (1, 2 and 4 bits)
    and fused with an int32 or int64 bias (1, 2, 4 and 8 bits): exact
    equality at n = 8, at a ragged n with the packed slice starting 0-7
    bytes past an aligned address, and at 64 Mi rows; timing at 64 Mi
    rows (aligned, and 1 byte past alignment)."""
    import torch

    from tidb_tpu_torch.copr.cuda import unpack_codes

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    for bits, bias_spec in K2_FORMS:
        bias = None if bias_spec is None else torch.tensor(
            bias_spec[0], dtype=getattr(torch, bias_spec[1]), device=dev)
        for n in (8, K2_RAGGED, KERNEL_ROWS):
            nb = n * bits // 8
            buf = torch.randint(0, 256, (nb + 8,), dtype=torch.uint8,
                                device=dev, generator=gen)
            for off in (range(8) if n == K2_RAGGED else (0,)):
                check_k2(buf[off:off + nb], bits, n, bias)
        r = time_k2(buf[:nb], bits, n, flush, bias)
        off1 = time_cuda(lambda: unpack_codes(buf[1:1 + nb], bits, n,
                                              bias=bias), flush=flush)
        log(f"K2 unpack_codes {k2_tag(bits, n, bias)}: {k2_times(r)} "
            f"({r['bytes']} bytes at 3.35 TB/s); kernel with the packed "
            f"input 1 byte past alignment {off1:.4f} ms; exact at n=8, "
            f"n={K2_RAGGED} (offsets 0-7) and n={n}")
        del buf
    del flush
    torch.cuda.empty_cache()


def record_unpack_inputs():
    """Route the path's K2 calls through a recorder: (bits, n, output
    dtype) -> [calls, the first packed input, its bias].  Returns
    (record, restore)."""
    import tidb_tpu_torch.copr.cuda as kcuda

    real = kcuda.unpack_codes
    seen = {}

    def recorder(packed, bits, n, bias=None):
        key = (bits, n, k2_out(bias))
        rec = seen.setdefault(key, [0, packed, bias])
        rec[0] += 1
        return real(packed, bits, n, bias=bias)

    kcuda.unpack_codes = recorder

    def restore():
        kcuda.unpack_codes = real

    return seen, restore


def path_kernel_phase(seen) -> list:
    """K2 against its plain version on the inputs the cold queries gave
    it, one per (bits, n, output dtype): exact equality, then the kernel
    timed at that input in turns with its plain version and with the
    unfused sequence it replaces."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8,
                        device=torch.device("cuda"))
    out = []
    for (bits, n, _dt), (calls, packed, bias) in sorted(seen.items()):
        if bits == 8 and bias is None:
            continue  # identity: no launch
        err = check_k2(packed, bits, n, bias)
        r = time_k2(packed, bits, n, flush, bias)
        r.update({"calls": calls, "max_abs_err": err})
        out.append(r)
        log(f"K2 on the path's input {k2_tag(bits, n, bias)} ({calls} "
            f"calls): {k2_times(r)}, exact")
    del flush
    torch.cuda.empty_cache()
    if not out:
        raise AssertionError("cold: no unpack input was recorded")
    return out


def check_and_time_k1(codes, mapping, n: int, flush, timed=True) -> dict:
    """K1 on one input: exact equality with the plain version (raises
    otherwise), then the kernel, the plain version and the library
    gather `mapping[idx]` timed; the library call is handed the codes
    already widened and clipped (idx), so it leaves out the clip.  The
    bound is the bytes K1 must move: n codes in, n values out, the
    mapping once."""
    import torch

    from tidb_tpu_torch.copr.cuda import remap_codes, remap_codes_plain

    cap = mapping.shape[0]
    got = remap_codes(codes, mapping, n)
    want = remap_codes_plain(codes, mapping, n)
    torch.cuda.synchronize()
    tag = (f"codes {str(codes.dtype)[6:]} map {str(mapping.dtype)[6:]} "
           f"cap {cap} n={n}")
    if got.shape != (n,) or got.dtype != mapping.dtype:
        raise AssertionError(f"remap_codes {tag}: {tuple(got.shape)} "
                             f"{got.dtype}")
    err = int((got.to(torch.int64) - want.to(torch.int64))
              .abs().max().item())
    if err != 0 or not torch.equal(got, want):
        raise AssertionError(f"remap_codes {tag}: max |err| {err}")
    nbytes = (n * (codes.element_size() + mapping.element_size())
              + cap * mapping.element_size())
    r = {"code": str(codes.dtype)[6:], "map": str(mapping.dtype)[6:],
         "cap": cap, "n": n, "max_abs_err": err, "tag": tag,
         "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}
    if timed:
        idx = codes.reshape(n).to(torch.int64).clamp(0, cap - 1)
        r["ms"] = time_cuda(lambda: remap_codes(codes, mapping, n),
                            flush=flush)
        r["plain_ms"] = time_cuda(
            lambda: remap_codes_plain(codes, mapping, n), flush=flush)
        r["library_ms"] = time_cuda(lambda: mapping[idx], flush=flush)
        del idx
    return r


def k1_phase():
    """K1 against its plain version on the card: uint8 and int64 codes
    (out of range of the mapping included: uint8 codes up to 255 and
    int64 codes from -3 to cap+5), mappings of cap 4 (int32 and int64,
    staged in shared memory), 2**16 and 2**22 (int32, read through the
    read-only cache), at n = 8 and 64 Mi rows: exact equality; timing
    at 64 Mi rows."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    for code_dt in (torch.uint8, torch.int64):
        for cap, map_dt in ((4, torch.int32), (4, torch.int64),
                            (1 << 16, torch.int32), (1 << 22, torch.int32)):
            lo, hi = (0, 255) if code_dt == torch.uint8 else (-3, cap + 5)
            mapping = torch.randint(-(1 << 31), 1 << 31, (cap,),
                                    device=dev, generator=gen).to(map_dt)
            for n in (8, KERNEL_ROWS):
                codes = torch.randint(lo, hi + 1, (n,), device=dev,
                                      generator=gen).to(code_dt)
                r = check_and_time_k1(codes, mapping, n, flush,
                                      timed=n == KERNEL_ROWS)
                del codes
            log(f"K1 remap_codes {r['tag']}: kernel {r['ms']:.4f} ms, "
                f"plain {r['plain_ms']:.4f} ms, library "
                f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bytes']} bytes at 3.35 TB/s), exact at n=8 and "
                f"n={n}")
    del flush
    torch.cuda.empty_cache()


def record_remap_inputs():
    """Route the path's K1 calls through a recorder: (code dtype, map
    dtype, cap, n) -> [calls, the first codes, its mapping].  Returns
    (record, restore)."""
    import tidb_tpu_torch.copr.cuda as kcuda

    real = kcuda.remap_codes
    seen = {}

    def recorder(codes, mapping, n):
        key = (str(codes.dtype), str(mapping.dtype), int(mapping.shape[0]),
               n)
        rec = seen.setdefault(key, [0, codes, mapping])
        rec[0] += 1
        return real(codes, mapping, n)

    kcuda.remap_codes = recorder

    def restore():
        kcuda.remap_codes = real

    return seen, restore


def path_k1_phase(seen) -> list:
    """K1 against its plain version on the inputs the path gave it, one
    per (code dtype, map dtype, cap, n): exact equality, timing there."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8,
                        device=torch.device("cuda"))
    out = []
    for _key, (calls, codes, mapping) in sorted(seen.items()):
        r = check_and_time_k1(codes, mapping, codes.numel(), flush)
        r["calls"] = calls
        out.append(r)
        log(f"K1 on the path's input {r['tag']} ({calls} calls): kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms, "
            f"exact")
    del flush
    torch.cuda.empty_cache()
    if not out:
        raise AssertionError("no remap input was recorded")
    return out


# ---------------------------------------------------------------------------
# independent reference: numpy over the generator's arrays
# ---------------------------------------------------------------------------

def dec(iv: int, scale: int):
    """A decimal as the session returns it: a float while the scaled int
    is exact in one (|iv| <= 2**53), past that an exact string."""
    if abs(iv) <= 1 << 53:
        return iv / 10**scale
    sign, a = ("-" if iv < 0 else ""), abs(iv)
    return f"{sign}{a // 10**scale}.{a % 10**scale:0{scale}d}"


def avg6(total: int, cnt: int):
    """avg of a scale-2 decimal at the output's scale 6, rounded half up
    (positive values)."""
    return dec((total * 10**4 + cnt // 2) // cnt, 6)


def numpy_reference(n: int) -> dict:
    """The SF10 cells' rows computed with numpy over `lineitem_chunks(n)`:
    int64 per-group counts and scaled sums (exact, folded into Python
    ints), averages rounded half up to the output's scale 6, values
    rendered as the session renders a decimal (scaled int / 10**scale).
    Returns name -> rows for q1, q6, ck1, ck2, sa, tn and mf."""
    import numpy as np

    from tidb_tpu_torch.tpch_data import LINEITEM_DICTS, lineitem_chunks
    from tidb_tpu_torch.types.values import parse_date

    q1_cut = parse_date("1998-09-02")
    q6_lo, q6_hi = parse_date("1994-01-01"), parse_date("1995-01-01")
    tn_lo = parse_date("1995-03-15")
    SA_MAX = 100_000
    G = 6  # returnflag (3) x linestatus (2)
    acc = {k: [0] * G for k in ("cnt", "qty", "price", "disc_price",
                                "charge", "disc")}
    q6 = 0
    q6_rows = 0
    ck2 = {j: [0, 0] for j in range(2)}  # linestatus -> [count, sum]
    sa_qty = np.zeros(SA_MAX + 1, np.int64)
    sa_cnt = np.zeros(SA_MAX + 1, np.int64)
    tn = []  # (price, orderkey) candidates
    mf = []  # MF's rows
    for (ok, qty, price, disc, tax, rf, ls, ship) in lineitem_chunks(
            n, SEED):
        m = ship <= q1_cut
        g = rf.astype(np.int64) * 2 + ls
        dp = price * (100 - disc)           # scale 4
        ch = dp * (100 + tax)               # scale 6
        for k in range(G):
            s = m & (g == k)
            acc["cnt"][k] += int(np.count_nonzero(s))
            acc["qty"][k] += int(qty[s].sum())
            acc["price"][k] += int(price[s].sum())
            acc["disc_price"][k] += int(dp[s].sum())
            acc["charge"][k] += int(ch[s].sum())
            acc["disc"][k] += int(disc[s].sum())
        in94 = (ship >= q6_lo) & (ship < q6_hi)
        m6 = in94 & (disc >= 5) & (disc <= 7) & (qty < 2400)
        q6 += int((price[m6] * disc[m6]).sum())  # scale 4
        q6_rows += int(np.count_nonzero(m6))
        for j in range(2):
            s = in94 & (ls == j)
            ck2[j][0] += int(np.count_nonzero(s))
            ck2[j][1] += int((price[s] * disc[s]).sum())  # scale 4
        s = ok <= SA_MAX
        sa_qty += np.bincount(ok[s], weights=qty[s],
                              minlength=SA_MAX + 1).astype(np.int64)
        sa_cnt += np.bincount(ok[s], minlength=SA_MAX + 1)
        s = ship >= tn_lo
        p, o = price[s], ok[s]
        kth = np.partition(p, len(p) - 10)[len(p) - 10]
        tn.extend(zip(p[p >= kth].tolist(), o[p >= kth].tolist()))
        s = price < 90_100
        mf.extend((int(a), dec(int(b), 2), dec(int(c), 2))
                  for a, b, c in zip(ok[s], price[s], disc[s]))

    out = {"q1": [], "ck1": []}
    for k in range(G):
        c = acc["cnt"][k]
        if not c:
            continue
        rf, ls = LINEITEM_DICTS[5][k // 2], LINEITEM_DICTS[6][k % 2]
        out["q1"].append((
            rf, ls, dec(acc["qty"][k], 2), dec(acc["price"][k], 2),
            dec(acc["disc_price"][k], 4), dec(acc["charge"][k], 6),
            avg6(acc["qty"][k], c), avg6(acc["price"][k], c),
            avg6(acc["disc"][k], c), c,
        ))
        out["ck1"].append((
            rf.lower(), ls, dec(acc["qty"][k], 2),
            dec(acc["disc_price"][k], 4), avg6(acc["disc"][k], c), c))
    out["q6"] = [(dec(q6, 4) if q6_rows else None,)]
    out["ck2"] = [(ord(LINEITEM_DICTS[6][j]), c, dec(sm, 4))
                  for j, (c, sm) in ck2.items() if c]
    out["sa"] = [(int(k), dec(int(sa_qty[k]), 2), int(sa_cnt[k]))
                 for k in np.flatnonzero(sa_cnt)]
    tn.sort(key=lambda t: (-t[0], t[1]))
    out["tn"] = [(o, dec(p, 2)) for p, o in tn[:10]]
    out["mf"] = mf
    return out


def q18_reference(n: int) -> dict:
    """q18i and q18p rows with numpy over `lineitem_chunks(n)`: per
    orderkey l_quantity sums (scale 2, exact: far below 2**53), kept
    where the sum exceeds 300."""
    import numpy as np

    from tidb_tpu_torch.tpch_data import lineitem_chunks
    from tidb_tpu_torch.types.values import parse_date

    cut = parse_date("1998-09-02")
    size = n // 4 + 2
    all_qty = np.zeros(size, np.int64)
    cut_qty = np.zeros(size, np.int64)
    for (ok, qty, _p, _d, _t, _rf, _ls, ship) in lineitem_chunks(n, SEED):
        all_qty += np.bincount(ok, weights=qty,
                               minlength=size).astype(np.int64)
        m = ship <= cut
        cut_qty += np.bincount(ok[m], weights=qty[m],
                               minlength=size).astype(np.int64)
    return {name: [(int(k), dec(int(q[k]), 2))
                   for k in np.flatnonzero(q > 30000)]
            for name, q in (("q18i", all_qty), ("q18p", cut_qty))}


def q3_reference() -> dict:
    """Domain J's rows with numpy over `q3_tables` (the stream the load
    read): q3p and q3d (the lookup join's sums of scale-4 revenue, exact
    in float64 far below 2**53), pt's three queries over orders, and
    ptl's over lineitem's PTL_SPANS rows, before and after the deletes
    of PTL_DELETE."""
    import numpy as np

    from tidb_tpu_torch.tpch_data import q3_tables
    from tidb_tpu_torch.types.values import format_date, parse_date

    cut = parse_date("1995-03-15")
    rev = np.zeros(J_ORDERS, np.float64)
    cnt = np.zeros(J_ORDERS, np.int64)
    d_cnt = np.zeros((5, 11), np.int64)
    d_rev = np.zeros((5, 11), np.float64)
    spans, s0 = [], 0
    for name, cols in q3_tables(J_LINEITEM, J_ORDERS, J_SEED):
        if name == "orders":
            okey, odate, prio = cols
            o_ok = odate < cut
            continue
        lk, price, disc, ship = cols
        # ptl's rows: this chunk's part of PTL_SPANS
        in_span = np.zeros(len(lk), np.bool_)
        for lo, hi in PTL_SPANS:
            in_span[max(lo - s0, 0):max(hi - s0, 0)] = True
        spans.append([c[in_span] for c in cols])
        s0 += len(lk)
        m = o_ok[lk] & (ship > cut)
        lk, v, dm = lk[m], (price * (100 - disc))[m], disc[m]
        rev += np.bincount(lk, weights=v, minlength=J_ORDERS)
        cnt += np.bincount(lk, minlength=J_ORDERS)
        cell = prio[lk] * 11 + dm
        d_cnt += np.bincount(cell, minlength=55).reshape(5, 11)
        d_rev += np.bincount(cell, weights=v, minlength=55).reshape(5, 11)
    rev_i = np.rint(rev).astype(np.int64)
    groups = np.flatnonzero(cnt)
    top = sorted(groups.tolist(), key=lambda k: (-int(rev_i[k]), k))[:10]
    out = {"q3p": [(k, format_date(int(odate[k])), int(prio[k]),
                    dec(int(rev_i[k]), 4)) for k in top],
           "q3d": [(p, dec(dd, 2), int(d_cnt[p, dd]),
                    dec(int(np.rint(d_rev[p, dd])), 4))
                   for p in range(5) for dd in range(11) if d_cnt[p, dd]]}
    sel = np.zeros(J_ORDERS, np.bool_)
    for lo, hi in PT_SPANS:
        sel[lo:hi] = True
    out["pt_agg"] = [(p, int(np.count_nonzero(sel & (prio == p))),
                      format_date(int(odate[sel & (prio == p)].min())),
                      format_date(int(odate[sel & (prio == p)].max())))
                     for p in range(5) if np.any(sel & (prio == p))]
    out["pt_topn"] = sorted(odate[sel].tolist(), reverse=True)[:10]
    out["pt_dates"] = {int(k): format_date(int(odate[k]))
                       for k in np.flatnonzero(sel)}
    f = np.flatnonzero(sel & (odate < parse_date(PT_CUT)))
    out["pt_filter"] = [(int(k), format_date(int(odate[k])), int(prio[k]))
                        for k in f]
    out["build_keys"] = {"q3p/q3d lookup": int(np.count_nonzero(o_ok))}
    li = [np.concatenate(c) for c in zip(*spans)]
    out["ptl"] = ptl_reference(li, np.ones(len(li[0]), np.bool_))
    out["ptl_del"] = ptl_reference(li, ~np.isin(li[0], PTL_DELETE))
    return out


def ptl_reference(li, keep) -> dict:
    """ptl's rows with numpy over the span rows `li` (lineitem's columns)
    that `keep` keeps."""
    import numpy as np

    from tidb_tpu_torch.types.values import format_date

    lk, price, disc, ship = (c[keep] for c in li)
    agg = []
    for dd in range(11):
        m = disc == dd
        if m.any():
            agg.append((dec(dd, 2), int(m.sum()),
                        format_date(int(ship[m].min())),
                        format_date(int(ship[m].max())),
                        dec(int(price[m].sum()), 2)))
    top = np.sort(price)[::-1][:10]
    near = price >= top[-1]
    f = np.flatnonzero(price < PTL_CUT)
    return {"ptl_agg": agg,
            "ptl_topn": [dec(int(p), 2) for p in top],
            "ptl_top_rows": {(dec(int(p), 2), format_date(int(d)))
                             for p, d in zip(price[near], ship[near])},
            "ptl_filter": [(int(lk[i]), dec(int(price[i]), 2),
                            format_date(int(ship[i]))) for i in f]}


def tpch_reference() -> dict:
    """Domain T's q3 and sj rows with numpy over `tpch_domain_tables`
    (the stream the load read)."""
    import numpy as np

    from tidb_tpu_torch.tpch_data import tpch_domain_tables
    from tidb_tpu_torch.types.values import format_date, parse_date

    cut = parse_date("1995-03-15")
    for name, _ddl, cols in tpch_domain_tables(T_SCALE, T_SEED):
        if name == "customer":
            building = cols[3] == "BUILDING"
        elif name == "orders":
            o_cust, odate = cols[1], cols[4]
        elif name == "lineitem":
            lk, price, disc, ship = cols[0], cols[4], cols[5], cols[9]
    n_orders = len(odate)
    o_ok = building[o_cust] & (odate < cut)
    m = o_ok[lk] & (ship > cut)
    rev = np.rint(np.bincount(lk[m], weights=(price * (100 - disc))[m],
                              minlength=n_orders)).astype(np.int64)
    groups = np.flatnonzero(np.bincount(lk[m], minlength=n_orders))
    top = sorted(groups.tolist(), key=lambda k: (-int(rev[k]), k))[:10]
    sj_keys = odate < parse_date("1994-09-01")
    sj = int(np.count_nonzero(sj_keys[lk]))
    return {"q3": [(k, dec(int(rev[k]), 4), format_date(int(odate[k])))
                   for k in top],
            "sj": [(sj,)],
            "build_keys": {"q3 lineitem probe": int(np.count_nonzero(o_ok)),
                           "sj probe": int(np.count_nonzero(sj_keys))}}


# ---------------------------------------------------------------------------
# path phases
# ---------------------------------------------------------------------------

def engines(sess, sql):
    rows = sess.execute("explain analyze " + sql)[0].rows
    return [r[4] for r in rows if "TableReader" in r[0]]


def _kernel_counts():
    """The kernels' own wrappers, which hold the launch counts (the
    recorders below stand in front of them)."""
    from tidb_tpu_torch.copr.cuda.remap import remap_codes
    from tidb_tpu_torch.copr.cuda.unpack import unpack_codes

    return remap_codes, unpack_codes


def run_queries(sess, label: str, n_rows: int, queries, reps: int = 5):
    """Each (name, sql) on the device engine: first latency, the median
    of `reps` steady runs, rows/s; every run's rows must agree (in order
    where the query orders them) and the scan must report
    `engine:mesh`.  K1's and K2's launch counts are set
    to 0 just before each query's runs and read just after."""
    k1, k2 = _kernel_counts()
    sess.execute("set tidb_use_tpu = 1")
    out = {}
    for name, sql in queries:
        k1.launches = k2.launches = 0
        t0 = time.perf_counter()
        rows = sess.query(sql)
        first = time.perf_counter() - t0
        steady = []
        for _ in range(reps):
            t0 = time.perf_counter()
            again = sess.query(sql)
            steady.append(time.perf_counter() - t0)
            if not same_rows(again, rows, name in ORDERED):
                raise AssertionError(f"{label} {name}: rows changed "
                                     "between runs")
        eng = engines(sess, sql)
        launches = {"remap_codes": k1.launches,
                    "unpack_codes": k2.launches}
        if not eng or not all("engine:mesh" in e for e in eng):
            raise AssertionError(f"{label} {name}: not on the device "
                                 f"path: {eng}")
        med = statistics.median(steady)
        out[name] = {"rows": rows, "first_s": first, "steady_s": med,
                     "steady_all_s": steady, "rows_per_s": n_rows / med,
                     "launches": launches}
        log(f"{label} {name}: first {first * 1e3:.1f} ms, steady median "
            f"{med * 1e3:.1f} ms over {reps} runs, "
            f"{n_rows / med:.4g} rows/s; launches K1 "
            f"{launches['remap_codes']}, K2 {launches['unpack_codes']}")
    return out


#: cells whose SQL orders its rows (the others compare as multisets)
ORDERED = ("q1", "tn", "q3p", "q3", "t3", "t5", "t10")


def same_rows(got, want, ordered: bool) -> bool:
    if ordered:
        return got == want
    return sorted(got, key=str) == sorted(want, key=str)


def check_rows(label: str, res: dict, want: dict):
    for name, r in res.items():
        if not same_rows(r["rows"], want[name], name in ORDERED):
            raise AssertionError(f"{label} {name}: rows != numpy "
                                 f"reference:\n{r['rows'][:20]}\n"
                                 f"{want[name][:20]}")
    log(f"{label}: {', '.join(res)} rows == numpy reference")


def q18_cells(sess, n_rows: int, want: dict) -> dict:
    """q18i and q18p at SF1: each blows the sort-mode budget.  The first
    run returns the rows (checked against numpy); the second, EXPLAIN
    ANALYZE, is timed as the steady run and names the route.  q18p must
    take the peel rung (mesh_agg_peel_total +1 a run, the scan on the
    mesh); q18i, whose device head would be a bare scan, leaves the
    fused program for the per-region rung."""
    from tidb_tpu_torch.metrics import REGISTRY

    k1, k2 = _kernel_counts()
    sess.execute("set tidb_use_tpu = 1")
    out = {}
    for name, sql, route in (("q18i", Q18I, "engine:tile-fanout"),
                             ("q18p", Q18P, "engine:mesh")):
        k1.launches = k2.launches = 0
        snap = REGISTRY.snapshot()
        peel0 = snap.get("mesh_agg_peel_total", 0)
        scans0 = snap.get("mesh_scans_total", 0)
        cpu0 = snap.get("cop_region_cpu_runs_total", 0)
        t0 = time.perf_counter()
        rows = sess.query(sql)
        first = time.perf_counter() - t0
        snap = REGISTRY.snapshot()
        peels = snap.get("mesh_agg_peel_total", 0) - peel0
        scans = snap.get("mesh_scans_total", 0) - scans0
        cpu_runs = snap.get("cop_region_cpu_runs_total", 0) - cpu0
        t0 = time.perf_counter()
        eng = engines(sess, sql)
        steady = time.perf_counter() - t0
        if not same_rows(rows, want[name], ordered=False):
            raise AssertionError(f"{name}: rows != numpy reference")
        if not eng or not all(route in e for e in eng):
            raise AssertionError(f"{name}: route {eng}, want {route}")
        if scans < 1:
            raise AssertionError(f"{name}: the fused program never ran")
        if peels != (1 if name == "q18p" else 0):
            raise AssertionError(f"{name}: {peels} agg peels")
        # q18i's sort-mode aggregation declines the per-tile program as
        # in the JAX package: its regions run on the CPU engine
        if (cpu_runs > 0) != (name == "q18i"):
            raise AssertionError(f"{name}: {cpu_runs} CPU-engine regions")
        out[name] = {"rows": len(rows), "first_s": first,
                     "steady_s": steady, "rows_per_s": n_rows / steady,
                     "peels": peels, "route": route,
                     "launches": {"remap_codes": k1.launches,
                                  "unpack_codes": k2.launches}}
        log(f"SF1 {name}: {len(rows)} rows == numpy reference; first "
            f"{first * 1e3:.1f} ms, steady (EXPLAIN ANALYZE) "
            f"{steady * 1e3:.1f} ms, {n_rows / steady:.4g} rows/s; "
            f"route {route}, agg peels {peels}, CPU-engine regions "
            f"{int(cpu_runs)}")
    return out


def explain_ops(sess, sql) -> list:
    rows = sess.execute("explain " + sql)[0].rows
    return [r[0].strip(" └─") for r in rows]


def join_cells(sess, label: str, n_rows: int, queries, want: dict,
               op: str, reps: int = 5) -> dict:
    """`run_queries` over join cells, each checked for its route: `op`
    (JoinLookup or JoinProbe) in a cop DAG of the plan, every scan on
    the mesh, no fusion split and no aggregation peel; rows against
    numpy."""
    from tidb_tpu_torch.metrics import REGISTRY

    for name, sql in queries:
        ops_ = explain_ops(sess, sql)
        if op not in ops_:
            raise AssertionError(f"{label} {name}: no {op} in {ops_}")
    snap = REGISTRY.snapshot()
    split0 = snap.get("fusion_splits_total", 0)
    peel0 = snap.get("mesh_agg_peel_total", 0)
    res = run_queries(sess, label, n_rows, queries, reps=reps)
    snap = REGISTRY.snapshot()
    if (snap.get("fusion_splits_total", 0) != split0
            or snap.get("mesh_agg_peel_total", 0) != peel0):
        raise AssertionError(f"{label}: a fusion split or an agg peel")
    check_rows(label, res, want)
    return res


def ma10_orders(n: int):
    """mA10's orders columns: o_orderkey = 1 .. n/4 + 1 and a priority
    code into PRIORITIES per order, drawn from M_SEED."""
    import numpy as np

    keys = np.arange(1, n // 4 + 2, dtype=np.int64)
    prio = np.random.default_rng(M_SEED).integers(
        0, len(PRIORITIES), len(keys)).astype(np.int32)
    return keys, prio


def ma10_reference(n: int, prio) -> list:
    """mA10's rows with numpy over `lineitem_chunks(n)` and the orders
    priorities: per priority the count and the scale-4 revenue sum
    (exact int64 per chunk, folded into Python ints)."""
    import numpy as np

    from tidb_tpu_torch.tpch_data import lineitem_chunks
    from tidb_tpu_torch.types.values import parse_date

    cut = parse_date("1995-03-15")
    cnt = [0] * len(PRIORITIES)
    rev = [0] * len(PRIORITIES)
    for (ok, _q, price, disc, _t, _rf, _ls, ship) in lineitem_chunks(
            n, SEED):
        m = ship > cut
        p = prio[ok[m] - 1]
        v = (price * (100 - disc))[m]
        for g in range(len(PRIORITIES)):
            s = p == g
            cnt[g] += int(np.count_nonzero(s))
            rev[g] += int(v[s].sum())
    return [(PRIORITIES[g].lower(), cnt[g], dec(rev[g], 4))
            for g in range(len(PRIORITIES)) if cnt[g]]


def mpp_cells(sess, label: str, n_rows: int, cells, want: dict,
              reps: int = 5) -> dict:
    """The MPP exchange engine's cells.  Each (name, sql, op, metric)
    must plan `op` (MPPJoin or MPPJoinTree) by EXPLAIN, run its first
    run and `reps` steady runs on its rung (`metric` +1 a run), move
    none of MPP_FAILURES, give the same rows every run and rows equal
    to `want[name]` (unless `want` is None: a fleet worker's rows are
    checked by the parent), and name an `engine:mpp-` rung in EXPLAIN
    ANALYZE.
    K1's and K2's launch counts are set to 0 just before each cell's
    runs and read just after."""
    from tidb_tpu_torch.metrics import REGISTRY

    k1, k2 = _kernel_counts()
    sess.execute("set tidb_use_tpu = 1")
    out = {}
    for name, sql, op, metric in cells:
        ops_ = explain_ops(sess, sql)
        if not any(o.startswith(op + "_") for o in ops_):
            raise AssertionError(f"{label} {name}: no {op} in {ops_}")
        snap = REGISTRY.snapshot()
        c0 = [snap.get(k, 0) for k in (metric,) + MPP_FAILURES]
        k1.launches = k2.launches = 0
        t0 = time.perf_counter()
        rows = sess.query(sql)
        first = time.perf_counter() - t0
        steady = []
        for _ in range(reps):
            t0 = time.perf_counter()
            again = sess.query(sql)
            steady.append(time.perf_counter() - t0)
            if not same_rows(again, rows, name in ORDERED):
                raise AssertionError(f"{label} {name}: rows changed "
                                     "between runs")
        launches = {"remap_codes": k1.launches,
                    "unpack_codes": k2.launches}
        snap = REGISTRY.snapshot()
        moved = [snap.get(k, 0) - c for k, c in zip(
            (metric,) + MPP_FAILURES, c0)]
        if moved[0] != 1 + reps or any(moved[1:]):
            raise AssertionError(f"{label} {name}: {metric} +{moved[0]} "
                                 f"over {1 + reps} runs, "
                                 f"{dict(zip(MPP_FAILURES, moved[1:]))}")
        if want is not None and not same_rows(rows, want[name],
                                              name in ORDERED):
            raise AssertionError(f"{label} {name}: rows != reference:\n"
                                 f"{rows[:10]}\n{want[name][:10]}")
        eng = [r[4] for r in sess.execute("explain analyze " + sql)[0].rows
               if r[0].strip(" └─").startswith(op + "_")]
        if not eng or not all("engine:mpp-" in e for e in eng):
            raise AssertionError(f"{label} {name}: route {eng}")
        route = re.search(r"engine:(\S+)", eng[0]).group(1)
        med = statistics.median(steady)
        out[name] = {"rows": rows, "first_s": first, "steady_s": med,
                     "steady_all_s": steady, "rows_per_s": n_rows / med,
                     "launches": launches, "route": route}
        log(f"{label} {name}: {len(rows)} rows == reference; route {route}"
            f", {metric} +{moved[0]}, fallback and overflow counters "
            f"unmoved; first {first * 1e3:.1f} ms, steady median "
            f"{med * 1e3:.1f} ms over {reps} runs, {n_rows / med:.4g} "
            f"rows/s; launches K1 {launches['remap_codes']}, K2 "
            f"{launches['unpack_codes']}")
    return out


def ma10_phase(sess, profiling: bool):
    """mA10 over the SF10 hot session: load the orders table, compute the
    numpy reference, run the cell with K1's inputs recorded, and print
    the peak device memory.  Returns (cell, K1 inputs)."""
    import torch

    from tidb_tpu_torch.tpch_data import load_arrays

    t0 = time.perf_counter()
    keys, prio = ma10_orders(SF10_ROWS)
    sess.execute("create table orders (o_orderkey bigint,"
                 " o_orderpriority varchar(15))")
    load_arrays(sess, "orders", [keys, prio], {1: PRIORITIES})
    sess.execute("analyze table orders")
    log(f"mA10: orders ({len(keys)} rows) loaded and analyzed in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    want = {"mA10": ma10_reference(SF10_ROWS, prio)}
    log(f"mA10 numpy reference: {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seen, restore = record_remap_inputs()
    try:
        res = mpp_cells(sess, "SF10", SF10_ROWS,
                        [("mA10", MA10, "MPPJoin",
                          "mpp_joins_shuffle_grouped_total")], want)
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated()
    res["mA10"]["peak_bytes"] = peak
    log(f"mA10: peak device memory {peak} bytes ({peak / 2**30:.2f} GiB, "
        f"torch.cuda.max_memory_allocated)")
    if res["mA10"]["launches"]["remap_codes"] <= 0:
        raise AssertionError(f"mA10: K1 launches {res['mA10']['launches']}")
    if len(seen) != 1:
        raise AssertionError(f"mA10: K1 inputs {list(seen)}")
    for (cdt, mdt, cap, n), (calls, _c, _m) in seen.items():
        log(f"mA10: K1 input codes {cdt[6:]} n={n}, map {mdt[6:]} cap "
            f"{cap}, {calls} calls")
    if profiling:
        profile_queries(sess, "SF10", [("mA10", MA10)])
    return res, seen


def t_mpp_cells(sess, want: dict, profiling: bool) -> dict:
    """Domain T's MPP cells: each one's reference is the port's host
    engine (computed once, its seconds logged); t3 and tsj also equal
    the numpy references of q3 and sj."""
    from tidb_tpu_torch.tpch_data import TPCH_QUERIES

    cells = [("mC", MC, "MPPJoin", "mpp_joins_shuffle_total"),
             ("mE", ME, "MPPJoin", "mpp_joins_shuffle_total")]
    cells += [(f"t{q[1:]}", TPCH_QUERIES[q], "MPPJoinTree",
               "mpp_tree_joins_total") for q in ("q3", "q5", "q10")]
    cells.append(("tsj", SJ, "MPPJoinTree", "mpp_tree_joins_total"))
    host = {}
    sess.execute("set tidb_use_tpu = 0")
    for name, sql, _op, _m in cells:
        t0 = time.perf_counter()
        host[name] = sess.query(sql)
        log(f"T {name} host-engine reference: {len(host[name])} rows in "
            f"{time.perf_counter() - t0:.1f} s")
    for name, numpy_name in (("t3", "q3"), ("tsj", "sj")):
        if not same_rows(host[name], want[numpy_name], True):
            raise AssertionError(f"T {name}: host engine != numpy "
                                 f"reference:\n{host[name]}\n"
                                 f"{want[numpy_name]}")
    log("T: t3 and tsj host-engine rows == numpy references")
    res = mpp_cells(sess, "T", int(8000 * T_SCALE), cells, host, reps=3)
    if profiling:
        profile_queries(sess, "T", [(c[0], c[1]) for c in cells])
    return res


def check_pt(name: str, rows, want: dict):
    if name != "pt_topn":
        if not same_rows(rows, want[name], ordered=False):
            raise AssertionError(f"{name}: rows != numpy reference:\n"
                                 f"{rows[:10]}\n{want[name][:10]}")
        return
    # one sort key with ties: the dates are the reference's, every row
    # is a real one inside the spans
    dates = [r[1] for r in rows]
    from tidb_tpu_torch.types.values import format_date

    if dates != [format_date(d) for d in want["pt_topn"]] or any(
            want["pt_dates"].get(k) != d for k, d in rows):
        raise AssertionError(f"pt_topn: {rows} != numpy reference")


def check_ptl(name: str, rows, want: dict):
    if name != "ptl_topn":
        if not same_rows(rows, want[name], ordered=False):
            raise AssertionError(f"{name}: rows != numpy reference:\n"
                                 f"{rows[:10]}\n{want[name][:10]}")
        return
    # prices may tie: the prices are the reference's, every row a real one
    if [r[0] for r in rows] != want["ptl_topn"] or any(
            tuple(r) not in want["ptl_top_rows"] for r in rows):
        raise AssertionError(f"ptl_topn: {rows} != numpy reference")


def tile_cells(sess, label: str, stmts, spans, check, profiling: bool,
               whole: bool, reps: int = 5) -> dict:
    """The per-tile rung.  Each (name, sql) is planned from SQL (its run
    over the whole table by the fused program is checked too when
    `whole`: its SQL then names the spans), then run with its reader
    over the disjoint handle `spans`, more ranges than the fused
    program's range slots: the request must report `tile-fanout` (the
    reader names the ranges), dispatch at least one device tile per
    tile the spans touch on every run, run no region on the CPU engine
    and no fused program, and give rows that `check(name, rows)`
    accepts."""
    from tidb_tpu_torch.copr.torch_engine import TILE
    from tidb_tpu_torch.metrics import REGISTRY
    from tidb_tpu_torch.session.session import run_over_spans

    touched = len({t for lo, hi in spans
                   for t in range(lo // TILE, (hi - 1) // TILE + 1)})
    k1, k2 = _kernel_counts()
    sess.execute("set tidb_use_tpu = 1")
    out = {}
    plans = {}
    for name, sql in stmts:
        full = sess.query(sql)
        if whole:
            check(name, full)
        phys = plans[sql] = sess.last_plan
        k1.launches = k2.launches = 0
        snap = REGISTRY.snapshot()
        c0 = [snap.get(k, 0) for k in ("dispatch_chunk_tile_ms_count",
                                       "cop_region_cpu_runs_total",
                                       "mesh_scans_total")]
        t0 = time.perf_counter()
        rows, eng = run_over_spans(sess, phys, spans)
        first = time.perf_counter() - t0
        steady = []
        for _ in range(reps):
            t0 = time.perf_counter()
            again, _e = run_over_spans(sess, phys, spans)
            steady.append(time.perf_counter() - t0)
            # every run is checked: a TopN's ties may come back in
            # another order as the regions finish in another order
            check(name, again)
        snap = REGISTRY.snapshot()
        tiles, cpu_runs, mesh = [
            snap.get(k, 0) - c for k, c in zip(
                ("dispatch_chunk_tile_ms_count", "cop_region_cpu_runs_total",
                 "mesh_scans_total"), c0)]
        check(name, rows)
        if not rows:
            raise AssertionError(f"{name}: no rows")
        if not eng or not all(
                e.startswith("tile-fanout")
                and f"{len(spans)} disjoint ranges" in e for e in eng):
            raise AssertionError(f"{name}: route {eng}")
        if tiles < touched * (1 + reps) or cpu_runs or mesh:
            raise AssertionError(f"{name}: tile dispatches {tiles} (spans "
                                 f"touch {touched} tiles), CPU regions "
                                 f"{cpu_runs}, fused runs {mesh}")
        med = statistics.median(steady)
        out[name] = {"rows": len(rows), "first_s": first, "steady_s": med,
                     "tile_dispatches": tiles, "route": eng[0],
                     "launches": {"remap_codes": k1.launches,
                                  "unpack_codes": k2.launches}}
        log(f"{label} {name}: {len(rows)} rows == numpy reference"
            f"{' == the fused program' + chr(39) + 's' if whole else ''}; "
            f"route {eng[0]}; {int(tiles)} device tile dispatches over "
            f"{1 + reps} runs (spans touch {touched} tiles), 0 CPU-engine "
            f"regions; first {first * 1e3:.1f} ms, steady median "
            f"{med * 1e3:.1f} ms")
    if profiling:
        profile_queries(
            sess, label, stmts,
            run=lambda sql: run_over_spans(sess, plans[sql], spans))
    return out


def ptl_cells(sess, want: dict, profiling: bool) -> dict:
    """ptl: the per-tile rung over Domain J's lineitem, 16 tiles, six
    spans that cross tile and region edges; then the lineitem rows of
    PTL_DELETE's orders are deleted and the aggregation and the filter
    run again over the spans, with the tiles' deletion masks."""
    from tidb_tpu_torch.metrics import REGISTRY

    out = tile_cells(sess, "ptl", PTL, PTL_SPANS,
                     lambda n, r: check_ptl(n, r, want["ptl"]), profiling,
                     whole=False)
    t0 = time.perf_counter()
    keys = ", ".join(map(str, PTL_DELETE))
    sess.execute(f"delete from lineitem where l_orderkey in ({keys})")
    log(f"ptl: deleted the lineitem rows of {len(PTL_DELETE)} orders in "
        f"{time.perf_counter() - t0:.1f} s")
    again = [(n + "_del", sql) for n, sql in PTL if n != "ptl_topn"]
    out.update(tile_cells(
        sess, "ptl", again, PTL_SPANS,
        lambda n, r: check_ptl(n[:-len("_del")], r, want["ptl_del"]),
        profiling, whole=False))
    return out


def join_phase(profiling: bool):
    """Domains T and J: the runtime filter (q3, sj), the lookup join hot
    and cold (q3p, q3d) and the per-tile rung (pt over orders, one tile;
    ptl over lineitem, 16 tiles, with deletes).  Returns (cells, the
    K2 inputs the cold join cells gave, keyed as `record_unpack_inputs`
    keys them)."""
    from tidb_tpu_torch.layout import hot_cap_bytes, set_hot_cap_bytes
    from tidb_tpu_torch.tpch_data import (Q3_SQL, TPCH_QUERIES,
                                          build_q3_tables, build_tpch_domain)

    t0 = time.perf_counter()
    sess = build_tpch_domain(scale=T_SCALE, seed=T_SEED, regions=8)
    log(f"domain T (scale {T_SCALE}): built in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    want = tpch_reference()
    log(f"domain T numpy reference: {time.perf_counter() - t0:.1f} s; "
        f"build keys {want['build_keys']}")
    t_cells = [("q3", TPCH_QUERIES["q3"]), ("sj", SJ)]
    # the runtime-filter path: with MPP allowed the planner makes both
    # join trees (t3 and tsj below)
    sess.execute("set tidb_allow_mpp = 0")
    tc = join_cells(sess, "T", int(8000 * T_SCALE), t_cells, want,
                    "JoinProbe", reps=3)
    for r in tc.values():
        if r["launches"] != {"remap_codes": 0, "unpack_codes": 0}:
            raise AssertionError(f"T: kernel launches {r['launches']}")
    if profiling:
        profile_queries(sess, "T", t_cells)
    sess.execute("set tidb_allow_mpp = 1")
    tc.update(t_mpp_cells(sess, want, profiling))
    tm = t_mesh_cells(sess, tc, profiling)
    reset_device_state()
    tc.update(srv_phase(sess, profiling))
    del sess
    gc.collect()
    reset_device_state()

    t0 = time.perf_counter()
    sess = build_q3_tables(J_LINEITEM, J_ORDERS, regions=8, seed=J_SEED)
    log(f"domain J: {J_LINEITEM} lineitem, {J_ORDERS} orders built in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    want = q3_reference()
    log(f"domain J numpy reference: {time.perf_counter() - t0:.1f} s; "
        f"build keys {want['build_keys']}")
    j_cells = [("q3p", Q3_SQL), ("q3d", Q3D)]
    hot = join_cells(sess, "J hot", J_LINEITEM, j_cells, want, "JoinLookup")
    for r in hot.values():
        if r["launches"] != {"remap_codes": 0, "unpack_codes": 0}:
            raise AssertionError(f"J hot: kernel launches {r['launches']}")
    if profiling:
        profile_queries(sess, "J hot", j_cells)
    pt = tile_cells(sess, "pt", PT, PT_SPANS,
                    lambda n, r: check_pt(n, r, want), profiling, whole=True)

    d = sess.domain
    table = d.storage.table(d.catalog.info_schema().table(
        "test", "lineitem").id)
    reset_device_state()
    saved_cap = hot_cap_bytes()
    cap = cold_cap(table)
    set_hot_cap_bytes(cap)
    log(f"J cold: hot-tier cap {cap} bytes")
    seen, restore = record_unpack_inputs()
    try:
        cold = join_cells(sess, "J cold", J_LINEITEM, j_cells, want,
                          "JoinLookup")
        if profiling:
            profile_queries(sess, "J cold", j_cells)
    finally:
        restore()
        set_hot_cap_bytes(saved_cap)
    cold_cols = {r[0] for r in sess.query(
        "select column_name from information_schema.tidb_tpu_column_layout"
        " where tier = 'cold'")}
    if "l_discount" not in cold_cols:
        raise AssertionError(f"J cold: cold columns {cold_cols}")
    for name, r in cold.items():
        if r["launches"]["unpack_codes"] <= 0 or \
                r["launches"]["remap_codes"]:
            raise AssertionError(f"J cold {name}: launches {r['launches']}")
    # last: ptl deletes rows, which the cells above do not expect
    reset_device_state()
    ptl = ptl_cells(sess, want, profiling)
    del sess
    gc.collect()
    reset_device_state()
    cells = {f"T {k}": v for k, v in tc.items()}
    cells.update({f"T {k}": v for k, v in tm.items()})
    cells.update({f"J hot {k}": v for k, v in hot.items()})
    cells.update({f"J cold {k}": v for k, v in cold.items()})
    cells.update(pt)
    cells.update(ptl)
    return cells, seen


# ---------------------------------------------------------------------------
# the serving phase: the MySQL wire server and the micro-batcher
# ---------------------------------------------------------------------------

class MiniClient:
    """A minimal MySQL protocol-4.1 client (handshake response,
    COM_QUERY, text result sets): the card machine has no MySQL client
    library."""

    def __init__(self, host, port):
        self.host, self.port = host, port

    async def connect(self, db=""):
        import asyncio
        import struct

        from tidb_tpu_torch.server import protocol as P
        from tidb_tpu_torch.server.packet import PacketReader, PacketWriter

        self.reader, self.writer = await asyncio.open_connection(
            self.host, self.port)
        self.pr = PacketReader(self.reader)
        self.pw = PacketWriter(self.writer)
        greeting = await self.pr.recv()
        assert greeting[0] == 10  # protocol version
        caps = P.CLIENT_PROTOCOL_41 | P.CLIENT_SECURE_CONNECTION
        if db:
            caps |= P.CLIENT_CONNECT_WITH_DB
        resp = struct.pack("<I", caps) + struct.pack("<I", 1 << 24)
        resp += bytes([33]) + b"\x00" * 23
        resp += b"root\x00" + b"\x00"  # user, empty auth
        if db:
            resp += db.encode() + b"\x00"
        self.pw.seq = self.pr.seq
        await self.pw.send(resp)
        ok = await self.pr.recv()
        assert ok[0] == 0x00, ok

    async def command(self, cmd: int, payload: bytes = b""):
        self.pw.reset_seq()
        await self.pw.send(bytes([cmd]) + payload)

    async def query(self, sql: str):
        import struct

        from tidb_tpu_torch.server.packet import (read_lenenc_int,
                                                  read_lenenc_str)

        await self.command(0x03, sql.encode())
        first = await self.pr.recv()
        if first[0] == 0x00:  # OK
            affected, _pos = read_lenenc_int(first, 1)
            return {"ok": True, "affected": affected}
        if first[0] == 0xFF:
            code = struct.unpack_from("<H", first, 1)[0]
            raise AssertionError(f"wire error {code}: {first[9:].decode()}"
                                 f" ({sql})")
        ncols, _ = read_lenenc_int(first, 0)
        cols = []
        for _ in range(ncols):
            cdef = await self.pr.recv()
            pos = 0
            vals = []
            for _ in range(6):
                v, pos = read_lenenc_str(cdef, pos)
                vals.append(v)
            cols.append(vals[4].decode())
        eof = await self.pr.recv()
        assert eof[0] == 0xFE
        rows = []
        while True:
            pkt = await self.pr.recv()
            if pkt[0] == 0xFE and len(pkt) < 9:
                break
            pos = 0
            row = []
            for _ in range(ncols):
                if pkt[pos] == 0xFB:
                    row.append(None)
                    pos += 1
                else:
                    v, pos = read_lenenc_str(pkt, pos)
                    row.append(v.decode())
            rows.append(tuple(row))
        return {"cols": cols, "rows": rows}

    async def close(self):
        await self.command(0x01)
        self.writer.close()


class ServerThread:
    """The port's MySQLServer, in this process, on an event loop of its
    own thread; `stop()` stops the server, its worker pool and the
    loop."""

    def __init__(self, domain, workers=None):
        import asyncio

        from tidb_tpu_torch.server import MySQLServer

        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       name="srv-loop", daemon=True)
        self.thread.start()
        self.srv = (MySQLServer(domain, port=0) if workers is None
                    else MySQLServer(domain, port=0, workers=workers))
        asyncio.run_coroutine_threadsafe(self.srv.start(),
                                         self.loop).result(60)

    def stop(self):
        import asyncio

        asyncio.run_coroutine_threadsafe(self.srv.stop(),
                                         self.loop).result(120)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(60)
        self.loop.close()
        self.srv.pool.shutdown(wait=True)


def srv_statements() -> list:
    """SRV_CONNS lists of SRV_STMTS (shape, sql, literals): shapes
    round-robin, literals drawn from default_rng(SRV_SEED) over the
    generator's own domains at T_SCALE (suppliers, parts, ship dates)."""
    import numpy as np

    from tidb_tpu_torch.types.values import format_date, parse_date

    rng = np.random.default_rng(SRV_SEED)
    n_supp = max(int(40 * T_SCALE), 10)
    n_part = int(200 * T_SCALE)
    # ship dates: an order date in [1992-01-01, 1998-12-01) + 1..119 days
    first = parse_date("1992-01-02")
    last = parse_date("1998-12-01") + 119
    conns = []
    for i in range(SRV_CONNS):
        stmts = []
        for j in range(SRV_STMTS):
            shape = "abc"[(i * SRV_STMTS + j) % 3]
            if shape == "b":
                d0 = int(rng.integers(first, last - 30))
                args = (d0, d0 + 30)
                sql = SRV_SHAPES[shape].format(format_date(d0),
                                               format_date(d0 + 30))
            else:
                hi = n_supp if shape == "a" else n_part
                args = (int(rng.integers(0, hi)),)
                sql = SRV_SHAPES[shape].format(*args)
            stmts.append((shape, sql, args))
        conns.append(stmts)
    return conns


def wire_text(v):
    """A value as the wire's text protocol renders it."""
    if v is None:
        return None
    return repr(v) if isinstance(v, float) else str(v)


def srv_reference(conns) -> dict:
    """Each statement's rows with numpy over `tpch_domain_tables` (the
    stream the load read), as wire text, sorted: counts and decimal sums
    as exact integers rendered the way the session renders a decimal."""
    import numpy as np

    from tidb_tpu_torch.tpch_data import tpch_domain_tables

    for name, _ddl, cols in tpch_domain_tables(T_SCALE, T_SEED):
        if name == "lineitem":
            li = cols
    okey, pkey, skey, qty, price = li[0], li[1], li[2], li[3], li[4]
    ship = li[9]
    rf_names, rf = np.unique(li[7], return_inverse=True)
    ls_names, ls = np.unique(li[8], return_inverse=True)
    want = {}
    for stmts in conns:
        for shape, sql, args in stmts:
            if sql in want:
                continue
            if shape == "a":
                m = skey == args[0]
                n = int(np.count_nonzero(m))
                rows = [(n, dec(int(qty[m].sum()), 2) if n else None,
                         dec(int(price[m].sum()), 2) if n else None)]
            elif shape == "b":
                m = (ship >= args[0]) & (ship < args[1])
                code = rf[m] * len(ls_names) + ls[m]
                p = price[m]
                rows = []
                for g in np.unique(code):
                    sel = code == g
                    rows.append((rf_names[g // len(ls_names)],
                                 ls_names[g % len(ls_names)],
                                 int(np.count_nonzero(sel)),
                                 dec(int(p[sel].sum()), 2)))
            else:
                m = pkey == args[0]
                rows = [(int(o), dec(int(q), 2))
                        for o, q in zip(okey[m], qty[m])]
            want[sql] = sorted(tuple(wire_text(v) for v in r) for r in rows)
    return want


def srv_pass(server, conns, window_ms: int, profiling: bool) -> dict:
    """One pass of every connection's statements over the wire, all
    connections at once, with the batching window at `window_ms` (SET
    GLOBAL over the wire, as a user turns it on).  A warm-up statement of
    each shape runs first, alone; the counters and the clock start
    after it."""
    import asyncio

    import torch

    from tidb_tpu_torch.metrics import REGISTRY

    host, port = server.srv.host, server.srv.port

    async def setup():
        cli = MiniClient(host, port)
        await cli.connect(db="test")
        await cli.query("set global tidb_tpu_microbatch_window_ms = "
                        f"{window_ms}")
        seen = set()
        for stmts in conns:
            for shape, sql, _a in stmts:
                if shape not in seen:
                    seen.add(shape)
                    await cli.query(sql)
        await cli.close()

    async def one(stmts, out):
        cli = MiniClient(host, port)
        await cli.connect(db="test")
        for shape, sql, _a in stmts:
            t0 = time.perf_counter()
            r = await cli.query(sql)
            out.append((shape, sql, time.perf_counter() - t0, r["rows"]))
        await cli.close()

    async def drive():
        outs = [[] for _ in conns]
        t0 = time.perf_counter()
        await asyncio.gather(*(one(st, o) for st, o in zip(conns, outs)))
        return time.perf_counter() - t0, [x for o in outs for x in o]

    asyncio.run(setup())
    snap0 = REGISTRY.snapshot()
    prof = None
    if profiling:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    wall, done = asyncio.run(drive())
    if prof is not None:
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)
    snap1 = REGISTRY.snapshot()
    moved = {k: snap1.get(k, 0) - snap0.get(k, 0) for k in SRV_COUNTERS}
    lat = sorted(x[2] for x in done)
    res = {"window_ms": window_ms, "stmts": len(done), "wall_s": wall,
           "stmts_per_s": len(done) / wall,
           "p50_ms": statistics.median(lat) * 1e3,
           "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))] * 1e3,
           "counters": moved, "done": done}
    if prof is not None:
        from torch.autograd import DeviceType

        busy = sum(getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))
                   for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU)
        res["device_ms"] = busy / 1e3
        res["idle"] = 1 - busy / (wall * 1e6)
    return res


def srv_routes(server, conns, window_ms: int) -> dict:
    """EXPLAIN ANALYZE of one statement of each shape over the wire:
    the engine its lineitem reader ran on."""
    import asyncio

    sqls = {}
    for stmts in conns:
        for shape, sql, _a in stmts:
            sqls.setdefault(shape, sql)

    async def body():
        cli = MiniClient(server.srv.host, server.srv.port)
        await cli.connect(db="test")
        await cli.query("set global tidb_tpu_microbatch_window_ms = "
                        f"{window_ms}")
        out = {}
        for shape, sql in sorted(sqls.items()):
            r = await cli.query("explain analyze " + sql)
            out[shape] = [row[4] for row in r["rows"]
                          if "TableReader" in row[0]]
        await cli.close()
        return out

    return asyncio.run(body())


def srv_phase(sess, profiling: bool) -> dict:
    """The serving path on Domain T: the port's MySQL server in this
    process, SRV_CONNS concurrent wire connections, two passes over the
    same statements (solo, then micro-batched), first on the server's
    default worker pool, then on a pool of one worker per connection
    (`_w32`: the window's waiting leaders then hold no slot a queued
    member needs).  Fails unless every pass's rows equal numpy, every
    batched statement ran in a batch (the counters) on
    `engine:microbatch` (EXPLAIN ANALYZE), batches held more than one
    member, and the solo passes moved no batch counter."""
    k1, k2 = _kernel_counts()
    conns = srv_statements()
    t0 = time.perf_counter()
    want = srv_reference(conns)
    log(f"srv numpy reference: {len(want)} statements in "
        f"{time.perf_counter() - t0:.1f} s")
    passes, routes = {}, {}
    k1.launches = k2.launches = 0
    for suffix, workers in (("", None), (f"_w{SRV_CONNS}", SRV_CONNS)):
        server = ServerThread(sess.domain, workers)
        try:
            for name, window in (("solo", 0), ("batched", SRV_WINDOW_MS)):
                passes[name + suffix] = srv_pass(server, conns, window,
                                                 profiling)
                passes[name + suffix]["workers"] = server.srv.workers
                if not suffix:
                    routes[name] = srv_routes(server, conns, window)
        finally:
            server.stop()
            from tidb_tpu_torch import serving

            serving.configure(microbatch_window_ms=0.0)
    launches = {"remap_codes": k1.launches, "unpack_codes": k2.launches}
    n = SRV_CONNS * SRV_STMTS
    for name, p in passes.items():
        bad = [(sql, rows[:5], want[sql][:5]) for _s, sql, _t, rows
               in p["done"] if sorted(rows, key=str) != sorted(
                   want[sql], key=str)]
        if len(p["done"]) != n or bad:
            raise AssertionError(f"srv {name}: {len(p['done'])} of {n} "
                                 f"statements, rows != numpy: {bad[:3]}")
        c = p["counters"]
        if name.startswith("solo") and any(c.values()):
            raise AssertionError(f"srv {name}: batch counters moved {c}")
        if name.startswith("batched") and (
                c["serving_batched_stmts_total"] != n
                or c["serving_batch_errors_total"]
                or not c["serving_batched_stmts_total"]
                > c["serving_batches_total"]):
            raise AssertionError(f"srv {name}: not every statement ran in "
                                 f"a batch, or no batch held more than "
                                 f"one member: {c}")
        dev = (f", device {p['device_ms']:.2f} ms, idle share "
               f"{p['idle']:.3f}" if "device_ms" in p else "")
        p["mean_batch"] = (c["serving_batched_stmts_total"]
                           / c["serving_batches_total"]
                           if c["serving_batches_total"] else 0.0)
        log(f"srv {name} ({p['workers']} workers, window "
            f"{p['window_ms']} ms): {n} statements in {p['wall_s']:.3f} s, "
            f"{p['stmts_per_s']:.1f} statements/s, latency p50 "
            f"{p['p50_ms']:.2f} ms, p99 {p['p99_ms']:.2f} ms; batches "
            f"{c['serving_batches_total']}, batched statements "
            f"{c['serving_batched_stmts_total']}, mean batch size "
            f"{p['mean_batch']:.2f}, batch errors "
            f"{c['serving_batch_errors_total']}{dev}")
        for shape in "abc":
            lat = sorted(t for s, _q, t, _r in p["done"] if s == shape)
            log(f"  srv {name} shape {shape}: {len(lat)} statements, p50 "
                f"{statistics.median(lat) * 1e3:.2f} ms, max "
                f"{lat[-1] * 1e3:.2f} ms")
        del p["done"]
    log(f"srv routes: {routes}")
    for shape, eng in routes["batched"].items():
        if not eng or not all("engine:microbatch" in e for e in eng):
            raise AssertionError(f"srv batched {shape}: route {eng}")
    for shape, eng in routes["solo"].items():
        if not eng or not all("engine:mesh" in e for e in eng):
            raise AssertionError(f"srv solo {shape}: route {eng}")
    if launches != {"remap_codes": 0, "unpack_codes": 0}:
        raise AssertionError(f"srv: kernel launches {launches}")
    ratio = {s: passes["batched" + s]["stmts_per_s"]
             / passes["solo" + s]["stmts_per_s"] for s in ("", "_w32")}
    log(f"srv: rows == numpy in every pass; batched / solo statements/s "
        f"{ratio['']:.3f} ({passes['solo']['workers']} workers), "
        f"{ratio['_w32']:.3f} ({SRV_CONNS} workers)")
    return {"srv": {"launches": launches, "passes": passes}}


# ---------------------------------------------------------------------------
# the float phase: fixed-order float sums on the card
# ---------------------------------------------------------------------------

def norm(rows):
    """tests/test_tpch.py `_norm`: floats rounded to 6 places."""
    return sorted((tuple(round(v, 6) if isinstance(v, float) else v
                         for v in r) for r in rows), key=str)


def fl_table():
    """(session, rows after `_norm`, math.fsum per group) of the fl
    table: FL_ROWS doubles over FL_GROUPS keys from FL_SEED."""
    import math

    import numpy as np

    from tidb_tpu_torch.session import Domain

    rng = np.random.default_rng(FL_SEED)
    keys = rng.integers(0, FL_GROUPS, FL_ROWS, dtype=np.int64)
    x = rng.random(FL_ROWS)
    d = Domain()
    sess = d.new_session()
    sess.execute("create table fl (k bigint, x double)")
    t = d.catalog.info_schema().table("test", "fl")
    store = d.storage.table(t.id)
    store.bulk_load_arrays([keys, x], ts=d.storage.current_ts())
    d.storage.regions.split_even(t.id, 8, store.base_rows)
    sess.execute("set tidb_use_tpu = 1")
    t0 = time.perf_counter()
    order = np.argsort(keys, kind="stable")
    bounds = np.searchsorted(keys[order], np.arange(FL_GROUPS + 1))
    fsum = [math.fsum(x[order[bounds[g]:bounds[g + 1]]])
            for g in range(FL_GROUPS)]
    want = norm([(g, int(bounds[g + 1] - bounds[g]), fsum[g])
                 for g in range(FL_GROUPS)])
    log(f"fl: {FL_ROWS} rows, {FL_GROUPS} groups; math.fsum reference "
        f"{time.perf_counter() - t0:.1f} s")
    return sess, want, fsum


def float_phase(profiling: bool) -> dict:
    """FL_ROWS doubles grouped by FL_GROUPS keys, past the unrolled sums'
    32 groups: in dense mode (a stored bigint key: the fixed-order
    segmented sum of ops/segment.py) and in sort mode (a computed key:
    `fusion.grouped_partial_states`' per-span sums), FL_RUNS runs each.
    Fails unless every run's rows are bit-identical, and equal
    math.fsum per group after `_norm`; then FL_BATCH with four
    literals, concurrently under a batching window (B x G = 400
    segments in one batched reduction), against its solo rows after
    `_norm`."""
    from tidb_tpu_torch import serving
    from tidb_tpu_torch.metrics import REGISTRY

    k1, k2 = _kernel_counts()
    sess, want, fsum = fl_table()
    d = sess.domain
    out = {}
    k1.launches = k2.launches = 0
    for name, sql in (("fl_dense", FL_DENSE), ("fl_sort", FL_SORT)):
        runs, times = [], []
        for _ in range(FL_RUNS):
            t0 = time.perf_counter()
            runs.append(sess.query(sql))
            times.append(time.perf_counter() - t0)
        eng = engines(sess, sql)
        bits = {repr(sorted(r, key=str)) for r in runs}
        if len(bits) != 1:
            raise AssertionError(f"{name}: {len(bits)} different results "
                                 f"in {FL_RUNS} runs")
        got = runs[0]
        if norm(got) != want:
            raise AssertionError(f"{name}: rows != math.fsum after _norm: "
                                 f"{norm(got)[:3]} vs {want[:3]}")
        if not eng or not all("engine:mesh" in e for e in eng):
            raise AssertionError(f"{name}: route {eng}")
        rel = max(abs(r[2] - fsum[r[0]]) / abs(fsum[r[0]]) for r in got)
        out[name] = {"steady_s": statistics.median(times[1:]),
                     "first_s": times[0], "max_rel_err": rel,
                     "rows": got}
        log(f"{name}: {FL_RUNS} runs bit-identical, rows == math.fsum "
            f"after _norm (max relative error {rel:.3e}); first "
            f"{times[0] * 1e3:.1f} ms, steady median "
            f"{out[name]['steady_s'] * 1e3:.1f} ms; route {eng}")
    if profiling:
        profile_queries(sess, "fl", [("fl_dense", FL_DENSE),
                                     ("fl_sort", FL_SORT)])
    out[f"fl_dense S={MESH_S}"] = fl_mesh(sess, want,
                                          out["fl_dense"]["rows"])
    # the dense shape micro-batched: four literals of a hoisted predicate
    sqls = [FL_BATCH.format(c) for c in FL_BATCH_CUTS]
    solo = [sess.query(q) for q in sqls]
    serving.configure(microbatch_window_ms=250.0)
    sessions = [d.new_session() for _ in sqls]
    results = [None] * len(sqls)
    errors = [None] * len(sqls)
    barrier = threading.Barrier(len(sqls))

    def run(i):
        barrier.wait()
        try:
            results[i] = sessions[i].query(sqls[i])
        except BaseException as e:  # noqa: BLE001 — checked below
            errors[i] = e

    b0 = REGISTRY.snapshot()
    threads = [threading.Thread(target=run, args=(i,), name=f"fl-{i}")
               for i in range(len(sqls))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    wall = time.perf_counter() - t0
    serving.configure(microbatch_window_ms=0.0)
    b1 = REGISTRY.snapshot()
    moved = {k: b1.get(k, 0) - b0.get(k, 0) for k in SRV_COUNTERS}
    if any(errors) or any(th.is_alive() for th in threads):
        raise AssertionError(f"fl batched: errors {errors}")
    if moved["serving_batches_total"] != 1 \
            or moved["serving_batched_stmts_total"] != len(sqls):
        raise AssertionError(f"fl batched: not one batch of {len(sqls)}: "
                             f"{moved}")
    for q, got, w in zip(sqls, results, solo):
        if norm(got) != norm(w):
            raise AssertionError(f"fl batched: rows != solo after _norm: "
                                 f"{q}")
    launches = {"remap_codes": k1.launches, "unpack_codes": k2.launches}
    log(f"fl batched: {len(sqls)} statements x {FL_GROUPS} groups in one "
        f"batch, {wall * 1e3:.1f} ms, rows == solo rows after _norm; "
        f"launches {launches}")
    out["fl_batch"] = {"wall_s": wall}
    del sess, d
    gc.collect()
    reset_device_state()
    out["fl_ops"] = float_op_times()
    return {"fl": {"launches": launches, "cells": out}}


def float_op_times() -> dict:
    """A dense float GROUP BY's reduction alone over FL_OP_ROWS rows and
    FL_GROUPS groups on the card, timed in turns: the fixed-order sum
    (`ops.masked_segment_sum`: stable sort, span lengths, per-span sums)
    against the atomic `index_add_` scatter it replaced, and three sums
    over the same codes sharing one `ops.SpanOrder` against three that
    each sort.  Each fixed-order form is checked equal, bit for bit, to
    its first call."""
    import torch

    from tidb_tpu_torch import ops

    dev = ops.device()
    g = torch.Generator(device=dev).manual_seed(FL_SEED)
    x = torch.rand(FL_OP_ROWS, dtype=torch.float64, device=dev, generator=g)
    gidx = torch.randint(0, FL_GROUPS, (FL_OP_ROWS,), device=dev,
                         generator=g)
    mask = torch.rand(FL_OP_ROWS, device=dev, generator=g) < 0.9
    xs = (x, x * 3.0, x - 0.5)
    zero = torch.zeros((), dtype=x.dtype, device=dev)

    def fixed():
        return ops.masked_segment_sum(x, gidx, mask, FL_GROUPS)

    def atomic():
        out = torch.zeros(FL_GROUPS, dtype=x.dtype, device=dev)
        return out.index_add_(0, gidx, torch.where(mask, x, zero))

    def three_shared():
        spans = ops.SpanOrder(gidx, FL_GROUPS)
        return [ops.masked_segment_sum(v, gidx, mask, FL_GROUPS, spans)
                for v in xs]

    def three_sorting():
        return [ops.masked_segment_sum(v, gidx, mask, FL_GROUPS)
                for v in xs]

    first = fixed().cpu().numpy()
    first3 = [r.cpu().numpy() for r in three_shared()]
    ms = time_turns({"fixed": fixed, "index_add_": atomic,
                     "three_shared": three_shared,
                     "three_sorting": three_sorting}, reps=10)
    if fixed().cpu().numpy().tobytes() != first.tobytes() or any(
            a.cpu().numpy().tobytes() != b.tobytes()
            for a, b in zip(three_sorting(), first3)):
        raise AssertionError("fl ops: a fixed-order sum changed its bits")
    rel = float(((atomic() - fixed()).abs() / fixed().abs()).max())
    log(f"fl ops ({FL_OP_ROWS} rows, {FL_GROUPS} groups): fixed-order "
        f"{ms['fixed']:.4f} ms, index_add_ {ms['index_add_']:.4f} ms "
        f"(relative difference {rel:.3e}); three sums sharing one sort "
        f"{ms['three_shared']:.4f} ms, each sorting "
        f"{ms['three_sorting']:.4f} ms")
    del x, gidx, mask, xs
    torch.cuda.empty_cache()
    return {"rows": FL_OP_ROWS, **ms, "index_add_rel_diff": rel}


# ---------------------------------------------------------------------------
# the mesh phase: S > 1 positions on the one card
# ---------------------------------------------------------------------------


def mesh_ids():
    from tidb_tpu_torch.copr import parallel

    return parallel._MESH.ids if parallel._MESH is not None else ()


def compare_s1(label: str, res: dict, s1: dict, S: int):
    """Each S-position cell's rows against the same cell's S = 1 rows
    (ints and decimals exactly, floats after `_norm`), and its steady
    wall beside S = 1's."""
    for name, r in res.items():
        if not same_rows(norm(r["rows"]), norm(s1[name]["rows"]),
                         name in ORDERED):
            raise AssertionError(f"{label} {name}: rows != S = 1 rows")
        ratio = r["steady_s"] / s1[name]["steady_s"]
        r["s1_steady_s"] = s1[name]["steady_s"]
        log(f"{label} {name}: rows == S = 1 rows; steady "
            f"{r['steady_s'] * 1e3:.1f} ms at S = {S} vs "
            f"{s1[name]['steady_s'] * 1e3:.1f} ms at S = 1 "
            f"({ratio:.2f}x)")


def mesh_failover(sess, want_q1, S: int) -> dict:
    """Failover on the card: position 3 fails once during Q1 (the
    `mesh/device_error` site); the rows must equal, the rebuilt mesh
    hold the other S - 1 positions, no column cache hold anything of
    position 3, and `mesh_failover_retries_total` move; after the
    cooldowns expire Q1 runs on all S positions again."""
    from tidb_tpu_torch.copr import parallel
    from tidb_tpu_torch.copr.device_health import (DEVICE_HEALTH,
                                                   DeviceFailure)
    from tidb_tpu_torch.layout import COLD_CACHE
    from tidb_tpu_torch.metrics import REGISTRY
    from tidb_tpu_torch.store.fault import failpoint, once
    from tidb_tpu_torch.tpch_data import LINEITEM_Q1

    r0 = REGISTRY.snapshot().get("mesh_failover_retries_total", 0)
    t0 = time.perf_counter()
    with failpoint("mesh/device_error", once(DeviceFailure(
            "position 3 halted mid-scan", device_ids=(3,)))):
        rows = sess.query(LINEITEM_Q1)
    failed_s = time.perf_counter() - t0
    r1 = REGISTRY.snapshot().get("mesh_failover_retries_total", 0)
    ids = mesh_ids()
    held = ([k for k in parallel.MESH_CACHE._cache if 3 in k[3]]
            + [k for k in COLD_CACHE.items_view if 3 in k[3]])
    if rows != want_q1 or len(ids) != S - 1 or 3 in ids or held \
            or r1 <= r0:
        raise AssertionError(f"mesh failover: rows ok {rows == want_q1}, "
                             f"mesh {ids}, held {held}, retries {r1 - r0}")
    DEVICE_HEALTH.expire_cooldowns()
    t0 = time.perf_counter()
    again = sess.query(LINEITEM_Q1)
    probe_s = time.perf_counter() - t0
    if again != want_q1 or len(mesh_ids()) != S:
        raise AssertionError(f"mesh failover: after the probe mesh "
                             f"{mesh_ids()}")
    DEVICE_HEALTH.reset()
    log(f"mesh failover: position 3 failed during Q1; rebuilt over {ids}, "
        f"rows == numpy reference, nothing of position 3 cached, "
        f"mesh_failover_retries_total +{r1 - r0}, {failed_s * 1e3:.1f} ms; "
        f"after the probe Q1 on {mesh_ids()} in {probe_s * 1e3:.1f} ms")
    return {"failed_s": failed_s, "probe_s": probe_s,
            "retries": r1 - r0, "rebuilt": list(ids)}


def mesh_phase(sess, table, want, s1_hot, s1_cold, profiling: bool,
               shards=MESH_S):
    """The SF10 cells at `shards` positions on the one card (None: one
    position a visible card), hot and cold: Q1, Q6, ck1, tn and the
    filter mf, each against numpy and against its S = 1 rows, on
    `engine:mesh` with no fallback counter moved; then failover.
    Returns (cells, K1 inputs, K2 inputs), the inputs as
    `record_remap_inputs` / `record_unpack_inputs` key them."""
    import torch

    from tidb_tpu_torch import ops
    from tidb_tpu_torch.layout import hot_cap_bytes, set_hot_cap_bytes
    from tidb_tpu_torch.tpch_data import LINEITEM_Q1, LINEITEM_Q6

    cells = [("q1", LINEITEM_Q1), ("q6", LINEITEM_Q6), ("ck1", CK1),
             ("tn", TN), ("mf", MF)]
    S = shards or torch.cuda.device_count()
    label = f"S={S}" if shards else f"{S} cards"
    reset_device_state()
    ops.use_device("cuda", shards=shards)
    default_cap = hot_cap_bytes()
    try:
        fail0 = failure_counters()
        seen_k1, restore_k1 = record_remap_inputs()
        try:
            hot = run_queries(sess, f"{label} hot", SF10_ROWS, cells)
        finally:
            restore_k1()
        if len(mesh_ids()) != S:
            raise AssertionError(f"{label}: mesh {mesh_ids()}")
        check_rows(f"{label} hot", hot, want)
        compare_s1(f"{label} hot", hot, s1_hot, S)
        for name, r in hot.items():
            if r["launches"]["unpack_codes"] or \
                    (r["launches"]["remap_codes"] > 0) != (name == "ck1"):
                raise AssertionError(f"{label} hot {name}: launches "
                                     f"{r['launches']}")
        if profiling:
            profile_queries(sess, f"{label} hot", cells)
        reset_device_state()
        set_hot_cap_bytes(cold_cap(table))
        seen_k2, restore = record_unpack_inputs()
        seen_k1c, restore_k1 = record_remap_inputs()
        try:
            cold = run_queries(sess, f"{label} cold", SF10_ROWS, cells)
            if profiling:
                profile_queries(sess, f"{label} cold", cells)
        finally:
            restore()
            restore_k1()
        check_rows(f"{label} cold", cold, want)
        compare_s1(f"{label} cold", cold,
                   {**s1_hot, **s1_cold}, S)
        for name, r in cold.items():
            if name in ("q1", "q6", "ck1") and \
                    r["launches"]["unpack_codes"] <= 0:
                raise AssertionError(f"{label} cold {name}: no K2 launch")
        fail1 = failure_counters()
        if fail1 != fail0:
            raise AssertionError(f"{label}: fallback counters moved: "
                                 f"{fail0} -> {fail1}")
        fo = mesh_failover(sess, want["q1"], S)
    finally:
        set_hot_cap_bytes(default_cap)
        reset_device_state()
        ops.use_device("cuda")
    for key, rec in seen_k1c.items():
        if key in seen_k1:
            seen_k1[key][0] += rec[0]
        else:
            seen_k1[key] = rec
    out = {f"{label} hot {k}": v for k, v in hot.items()}
    out.update({f"{label} cold {k}": v for k, v in cold.items()})
    out[f"{label} failover"] = {**fo, "launches": {"remap_codes": 0,
                                                   "unpack_codes": 0}}
    return out, seen_k1, seen_k2


def ma10_mesh(sess, s1: dict, want: dict, profiling: bool):
    """mA10 at MESH_MA10_S positions (MESH_S, and 2, whose static
    exchange capacities are half as large): rows against numpy and S = 1,
    on its rung, with the peak device memory of each.  Returns (cells,
    K1 inputs)."""
    import torch

    from tidb_tpu_torch import ops

    out, seen = {}, {}
    for S in MESH_MA10_S:
        label = f"S={S}"
        reset_device_state()
        ops.use_device("cuda", shards=S)
        try:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            rec, restore = record_remap_inputs()
            try:
                res = mpp_cells(sess, label, SF10_ROWS,
                                [("mA10", MA10, "MPPJoin",
                                  "mpp_joins_shuffle_grouped_total")], want)
            finally:
                restore()
            peak = torch.cuda.max_memory_allocated()
            if len(mesh_ids()) != S:
                raise AssertionError(f"{label} mA10: mesh {mesh_ids()}")
            compare_s1(label, res, s1, S)
            res["mA10"]["peak_bytes"] = peak
            log(f"{label} mA10: peak device memory {peak} bytes "
                f"({peak / 2**30:.2f} GiB) against S = 1's "
                f"{s1['mA10']['peak_bytes'] / 2**30:.2f} GiB")
            if res["mA10"]["launches"]["remap_codes"] <= 0:
                raise AssertionError(f"{label} mA10: K1 launches "
                                     f"{res['mA10']['launches']}")
            if profiling:
                profile_queries(sess, label, [("mA10", MA10)])
        finally:
            reset_device_state()
            ops.use_device("cuda")
        out[f"{label} mA10"] = res["mA10"]
        for key, r in rec.items():
            if key in seen:
                seen[key][0] += r[0]
            else:
                seen[key] = r
    return out, seen


def t_mesh_cells(sess, s1: dict, profiling: bool) -> dict:
    """Domain T's join trees t3, t10 and tsj at MESH_S positions, against
    their S = 1 rows (which equal the host engine's and, for t3 and
    tsj, numpy's)."""
    from tidb_tpu_torch import ops
    from tidb_tpu_torch.tpch_data import TPCH_QUERIES

    sql = {"t3": TPCH_QUERIES["q3"], "t10": TPCH_QUERIES["q10"], "tsj": SJ}
    cells = [(n, sql[n], "MPPJoinTree", "mpp_tree_joins_total")
             for n in MESH_T]
    label = f"T S={MESH_S}"
    reset_device_state()
    ops.use_device("cuda", shards=MESH_S)
    try:
        res = mpp_cells(sess, label, int(8000 * T_SCALE), cells,
                        {n: s1[n]["rows"] for n in MESH_T}, reps=3)
        if len(mesh_ids()) != MESH_S:
            raise AssertionError(f"{label}: mesh {mesh_ids()}")
        compare_s1(label, res, s1, MESH_S)
        if profiling:
            profile_queries(sess, label, [(c[0], c[1]) for c in cells])
    finally:
        reset_device_state()
        ops.use_device("cuda")
    return {f"S={MESH_S} {k}": v for k, v in res.items()}


def fl_mesh(sess, want, s1_dense) -> dict:
    """fl_dense at MESH_S positions, FL_RUNS runs: every run's rows must
    have the same bits (float partials merge in shard order), and equal
    math.fsum and the S = 1 rows after `_norm`."""
    from tidb_tpu_torch import ops

    ops.use_device("cuda", shards=MESH_S)
    try:
        runs, times = [], []
        for _ in range(FL_RUNS):
            t0 = time.perf_counter()
            runs.append(sess.query(FL_DENSE))
            times.append(time.perf_counter() - t0)
        if len(mesh_ids()) != MESH_S:
            raise AssertionError(f"fl_dense S={MESH_S}: mesh {mesh_ids()}")
        eng = engines(sess, FL_DENSE)
    finally:
        reset_device_state()
        ops.use_device("cuda")
    bits = {repr(sorted(r, key=str)) for r in runs}
    if len(bits) != 1:
        raise AssertionError(f"fl_dense S={MESH_S}: {len(bits)} different "
                             f"results in {FL_RUNS} runs")
    if norm(runs[0]) != want or norm(runs[0]) != norm(s1_dense):
        raise AssertionError(f"fl_dense S={MESH_S}: rows != math.fsum / "
                             "S = 1 after _norm")
    if not eng or not all("engine:mesh" in e for e in eng):
        raise AssertionError(f"fl_dense S={MESH_S}: route {eng}")
    steady = statistics.median(times[1:])
    log(f"fl_dense S={MESH_S}: {FL_RUNS} runs bit-identical, rows == "
        f"math.fsum and S = 1 after _norm; first {times[0] * 1e3:.1f} ms, "
        f"steady median {steady * 1e3:.1f} ms")
    return {"steady_s": steady, "first_s": times[0]}


def profile_queries(sess, label: str, queries, run=None):
    """One steady run of each (name, sql) under torch.profiler, printed:
    wall time, the summed device time of the kernels, the device's idle
    share, and the operators that take the most device and host time.
    `run(sql)` runs a statement (default: `sess.query`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run = run or sess.query
    for name, sql in queries:
        run(sql)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(sql)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        ka = list(prof.key_averages())

        def dev_us(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))

        # the device's own events (kernels, copies, memsets): an operator
        # on the host may carry its kernels' time as its own self device
        # time too (the MPP cells' aten::sort, aten::index, ...), and a
        # named range (`mpp.pack`) has a device-side twin spanning its
        # kernels; either would count those kernels twice
        on_card = [e for e in ka if e.device_type != DeviceType.CPU
                   and not e.key.startswith("mpp.")]
        busy = sum(dev_us(e) for e in on_card)
        top_dev = sorted(on_card, key=dev_us, reverse=True)[:10]
        top_cpu = sorted(ka, key=lambda e: e.self_cpu_time_total,
                         reverse=True)[:10]
        busy_txt = (f"{busy / 1e3:.2f} ms, idle share "
                    f"{1 - busy / wall_us:.3f}" if busy else "not measured")
        log(f"profile {label} {name}: wall {wall_us / 1e3:.2f} ms, device "
            f"kernels {busy_txt}")
        for e in top_dev:
            log(f"  device {dev_us(e) / 1e3:9.3f} ms {e.count:5d}x {e.key}")
        for e in ka:
            if e.key.startswith("mpp.") and e.device_type == DeviceType.CPU:
                # a named range: the device time of the kernels it ran
                total = getattr(e, "device_time_total",
                                getattr(e, "cuda_time_total", 0.0))
                log(f"  range  {total / 1e3:9.3f} ms {e.count:5d}x {e.key}")
        for e in top_cpu:
            log(f"  host   {e.self_cpu_time_total / 1e3:9.3f} ms "
                f"{e.count:5d}x {e.key}")


def sf1_host_check():
    """At SF1 the device rows must equal the port's host engine's rows."""
    from tidb_tpu_torch.tpch_data import (LINEITEM_Q1, LINEITEM_Q6,
                                          build_lineitem)

    t0 = time.perf_counter()
    sess = build_lineitem(SF1_ROWS, seed=SEED)
    log(f"SF1 load: {SF1_ROWS} rows in {time.perf_counter() - t0:.1f} s")
    for name, sql in (("q1", LINEITEM_Q1), ("q6", LINEITEM_Q6)):
        sess.execute("set tidb_use_tpu = 1")
        dev_rows = sess.query(sql)
        if not all("engine:mesh" in e for e in engines(sess, sql)):
            raise AssertionError(f"SF1 {name}: not on the device path")
        sess.execute("set tidb_use_tpu = 0")
        t0 = time.perf_counter()
        host_rows = sess.query(sql)
        if dev_rows != host_rows:
            raise AssertionError(f"SF1 {name}: device {dev_rows} != "
                                 f"host {host_rows}")
        log(f"SF1 {name}: device rows == host-engine rows "
            f"({len(host_rows)} rows; host engine "
            f"{time.perf_counter() - t0:.1f} s)")
    return sess


def reset_device_state():
    from tidb_tpu_torch.copr import parallel
    from tidb_tpu_torch.layout import LAYOUT, coldtier

    for t in threading.enumerate():
        if t.name == "tidb-tpu-prefetch":
            t.join()
    from tidb_tpu_torch.copr import torch_engine

    parallel.MESH_CACHE.clear()
    coldtier.clear()
    torch_engine.DEVICE_CACHE.clear()
    LAYOUT.reset()


def failure_counters():
    from tidb_tpu_torch.metrics import REGISTRY

    snap = REGISTRY.snapshot()
    return {k: snap.get(k, 0) for k in (
        "layout_cold_fallbacks_total", 
        "mesh_failover_retries_total", "mesh_hbm_oom_total",
        "cache_demote_errors_total")}


def cold_cap(table) -> int:
    """A hot-tier cap whose tuner budget (cap x its fill factor) holds
    the columns that cannot pack plus half the smallest packable one, so
    every packable column goes cold and the rest stays hot.  (For Domain
    J's lineitem, whose one packable column is a byte a row, the cap
    itself lies above the table's wire bytes; only the budget decides.)"""
    from tidb_tpu_torch.layout import autotuner
    from tidb_tpu_torch.layout.coldtier import pack_info

    by_col = {ci: autotuner._column_wire_bytes(table, ci)
              for ci in range(table.n_cols)}
    packable = [ci for ci in by_col if pack_info(table, ci) is not None]
    unpackable = sum(b for ci, b in by_col.items() if ci not in packable)
    smallest = min(by_col[ci] for ci in packable)
    cap = int((unpackable + smallest // 2) / autotuner.LayoutEngine.HOT_FILL)
    budget = cap * autotuner.LayoutEngine.HOT_FILL
    if not unpackable <= budget < unpackable + smallest:
        raise AssertionError(f"no cold cap: unpackable {unpackable}, "
                             f"smallest packable {smallest}, budget "
                             f"{budget}")
    return cap


# ---------------------------------------------------------------------------
# the fleet phases: processes on the one card
# ---------------------------------------------------------------------------

#: mh: MH_PROCS processes join one torch.distributed group (gloo: NCCL
#: refuses two ranks on one device), each placing MH_LOCAL positions on
#: the card, so one mesh spans MH_PROCS x MH_LOCAL positions
MH_PROCS = 2
MH_LOCAL = 2
MH_CELLS = (("q1", None), ("q6", None), ("ck1", CK1))
MH_T = ("t3", "tsj")
#: dp: the coordinator in this process, DP_MEMBERS member processes on
#: the card (one position each), RF = 1; DP_ROUNDS rounds hot and cold
#: before member DP_MEMBERS - 1 is killed
DP_MEMBERS = 2
DP_ROUNDS = 3
DP_LEASE_S = 5.0
#: a worker's run, its SF10 build included, must end within this
FLEET_TIMEOUT_S = 900
FLEET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "fleet")


def _sql(name, sql):
    from tidb_tpu_torch.tpch_data import LINEITEM_Q1, LINEITEM_Q6

    return sql or {"q1": LINEITEM_Q1, "q6": LINEITEM_Q6}[name]


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(kind: str, pid: int, args, log_path: str):
    """One fleet worker: this script with --fleet-worker, its output in
    `log_path`."""
    cmd = [sys.executable, os.path.abspath(__file__), "--fleet-worker",
           kind, str(pid)] + [str(a) for a in args]
    return subprocess.Popen(cmd, stdout=open(log_path, "w"),
                            stderr=subprocess.STDOUT,
                            cwd=os.path.dirname(os.path.abspath(__file__)))


def _echo(label: str, log_path: str):
    """A worker's log, each line prefixed (the record of its run)."""
    with open(log_path) as f:
        for line in f:
            if "Warning" in line or line.startswith(("  return func",
                                                     "[W")):
                continue
            log(f"{label} | {line.rstrip()}")


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


def _wait_all(procs, labels, logs, timeout_s: float):
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise subprocess.TimeoutExpired(p.args, timeout_s)
            p.wait(timeout=left)
    except subprocess.TimeoutExpired:
        _stop(procs)
        for lb, lp in zip(labels, logs):
            _echo(lb, lp)
        raise AssertionError(f"fleet workers did not end in {timeout_s} s")
    for lb, lp in zip(labels, logs):
        _echo(lb, lp)
    bad = [(lb, p.returncode) for lb, p in zip(labels, procs)
           if p.returncode != 0]
    if bad:
        raise AssertionError(f"fleet workers failed: {bad}")


def _peak_gib() -> float:
    import torch

    return torch.cuda.max_memory_allocated() / (1 << 30)


def _cell_record(r: dict) -> dict:
    return {k: r[k] for k in ("rows", "first_s", "steady_s", "launches")
            if k in r}


def _fleet_device(layout: str, pid: int, nprocs: int):
    """A fleet process's positions: MH_LOCAL of them on the one card
    ("share"), or card `pid` alone ("cards": one process a card)."""
    import torch

    from tidb_tpu_torch import ops

    if layout == "share":
        ops.use_device("cuda", shards=MH_LOCAL)
    else:
        ops.use_device(f"cuda:{pid}")
        torch.cuda.set_device(pid)
    # the processes share the host's cores: no oversubscribed torch pool
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // nprocs))


def mh_worker(pid: int, nprocs: int, layout: str, port: str,
              out_path: str) -> int:
    """One process of the `mh` phase: joins the group, builds the SF10
    lineitem from SEED (every process regenerates the same arrays), runs
    Q1, Q6 and ck1 hot and cold, holds K1 and K2 against their plain
    versions on its own per-shard inputs (one process at a time), then
    Domain T's t3 and tsj and fl_dense (FL_RUNS runs); writes its rows,
    walls, launches and peak device memory to `out_path` (pickle)."""
    import pickle

    import torch
    import torch.distributed as dist

    os.environ.update({
        "TIDB_TPU_COORDINATOR": f"127.0.0.1:{port}",
        "TIDB_TPU_NUM_PROCESSES": str(nprocs),
        "TIDB_TPU_PROCESS_ID": str(pid),
        "TIDB_TPU_DIST_TIMEOUT_S": str(FLEET_TIMEOUT_S),
        "TIDB_TPU_DISPATCH_CHUNK_ROWS": str(CHUNK_ROWS)})
    from tidb_tpu_torch import ops
    from tidb_tpu_torch.copr import parallel
    from tidb_tpu_torch.layout import hot_cap_bytes, set_hot_cap_bytes
    from tidb_tpu_torch.tpch_data import (TPCH_QUERIES, build_lineitem,
                                          build_tpch_domain)

    _fleet_device(layout, pid, nprocs)
    parallel._maybe_init_multihost()
    backend = dist.get_backend()
    tag = f"mh[{pid}]"
    log(f"{tag}: joined {ops.process_count()} processes, backend "
        f"{backend}, positions {list(ops.device_ids())}")
    out = {"pid": pid, "backend": backend, "peak_gib": {}}
    t0 = time.perf_counter()
    sess = build_lineitem(SF10_ROWS, seed=SEED)
    out["load_s"] = time.perf_counter() - t0
    log(f"{tag}: SF10 load {out['load_s']:.1f} s (regenerated from seed "
        f"{SEED})")
    ops.agree(0)  # both loaded
    d = sess.domain
    table = d.storage.table(d.catalog.info_schema().table(
        "test", "lineitem").id)
    cells = [(n, _sql(n, q)) for n, q in MH_CELLS]
    torch.cuda.reset_peak_memory_stats()
    seen_k1, restore_k1 = record_remap_inputs()
    try:
        hot = run_queries(sess, f"{tag} hot", SF10_ROWS, cells)
    finally:
        restore_k1()
    out["peak_gib"]["hot"] = _peak_gib()
    out["mesh"] = list(mesh_ids())
    out["local"] = list(parallel._MESH.local)
    default_cap = hot_cap_bytes()
    reset_device_state()
    set_hot_cap_bytes(cold_cap(table))
    torch.cuda.reset_peak_memory_stats()
    seen_k2, restore = record_unpack_inputs()
    seen_k1c, restore_k1 = record_remap_inputs()
    try:
        cold = run_queries(sess, f"{tag} cold", SF10_ROWS, cells)
    finally:
        restore()
        restore_k1()
    out["peak_gib"]["cold"] = _peak_gib()
    for key, rec in seen_k1c.items():
        if key in seen_k1:
            seen_k1[key][0] += rec[0]
        else:
            seen_k1[key] = rec
    for p in range(nprocs):  # one process times at a time
        ops.agree(0)
        if p == pid:
            out["k2_inputs"] = path_kernel_phase(seen_k2)
            out["k1_inputs"] = path_k1_phase(seen_k1)
    ops.agree(0)
    del seen_k1, seen_k2, seen_k1c
    out["hot"] = {k: _cell_record(v) for k, v in hot.items()}
    out["cold"] = {k: _cell_record(v) for k, v in cold.items()}
    set_hot_cap_bytes(default_cap)
    del sess, d, table
    gc.collect()
    reset_device_state()

    t0 = time.perf_counter()
    sess = build_tpch_domain(scale=T_SCALE, seed=T_SEED, regions=8)
    log(f"{tag}: domain T built in {time.perf_counter() - t0:.1f} s")
    sess.execute("set tidb_allow_mpp = 1")
    sql = {"t3": TPCH_QUERIES["q3"], "tsj": SJ}
    torch.cuda.reset_peak_memory_stats()
    t = mpp_cells(sess, f"{tag} T", int(8000 * T_SCALE),
                  [(n, sql[n], "MPPJoinTree", "mpp_tree_joins_total")
                   for n in MH_T], None, reps=2)
    out["peak_gib"]["T"] = _peak_gib()
    out["t"] = {k: _cell_record(v) for k, v in t.items()}
    del sess
    gc.collect()
    reset_device_state()

    sess, fl_want, _fsum = fl_table()
    runs, times = [], []
    for _ in range(FL_RUNS):
        t0 = time.perf_counter()
        runs.append(sess.query(FL_DENSE))
        times.append(time.perf_counter() - t0)
    if len({repr(sorted(r, key=str)) for r in runs}) != 1:
        raise AssertionError(f"{tag} fl_dense: runs differ")
    if norm(runs[0]) != fl_want:
        raise AssertionError(f"{tag} fl_dense: != math.fsum after _norm")
    eng = engines(sess, FL_DENSE)
    if not eng or not all("engine:mesh" in e for e in eng):
        raise AssertionError(f"{tag} fl_dense: route {eng}")
    out["fl"] = {"rows": runs[0], "first_s": times[0],
                 "steady_s": statistics.median(times[1:])}
    log(f"{tag} fl_dense: {FL_RUNS} runs bit-identical; steady "
        f"{out['fl']['steady_s'] * 1e3:.1f} ms")
    del sess
    gc.collect()
    reset_device_state()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    ops.agree(0)
    dist.destroy_process_group()
    return 0


def mh_phase(want: dict, s1: dict, nprocs: int = MH_PROCS,
             layout: str = "share") -> dict:
    """The `mh` phase: `nprocs` processes on the one card, one mesh of
    nprocs x MH_LOCAL positions over gloo ("share"), or one process a
    card over nccl ("cards", tools/fleet_cards.py).  Every process's rows must be equal,
    equal numpy (q1, q6, ck1, t3 against q3, tsj against sj) and, where
    `s1` has them, the same cells' S = 1 rows; fl_dense equal
    math.fsum after `_norm`.  K1 and K2 must have launched in each
    process and matched their plain versions on its inputs.  Prints
    each process's steady walls and peak device memory beside S = 1 and
    the in-process mesh."""
    import pickle

    os.makedirs(FLEET_DIR, exist_ok=True)
    port = _free_port()
    logs = [os.path.join(FLEET_DIR, f"mh{p}.log") for p in range(nprocs)]
    outs = [os.path.join(FLEET_DIR, f"mh{p}.pkl") for p in range(nprocs)]
    t0 = time.perf_counter()
    procs = []
    try:
        for p in range(nprocs):
            procs.append(_spawn("mh", p, [nprocs, layout, port, outs[p]],
                                logs[p]))
        # Domain T's numpy references while the workers run
        tw = tpch_reference()
        _wait_all(procs, [f"mh[{p}]" for p in range(nprocs)], logs,
                  FLEET_TIMEOUT_S)
    finally:
        _stop(procs)
    wall = time.perf_counter() - t0
    res = []
    for path in outs:
        with open(path, "rb") as f:
            res.append(pickle.load(f))
    per = MH_LOCAL if layout == "share" else 1
    backend = "gloo" if layout == "share" else "nccl"
    n_pos = nprocs * per
    refs = {"q1": want["q1"], "q6": want["q6"], "ck1": want["ck1"],
            "t3": tw["q3"], "tsj": tw["sj"]}
    cells = {}
    for r in res:
        p = r["pid"]
        if r["backend"] != backend or r["mesh"] != list(range(n_pos)) \
                or r["local"] != list(range(p * per, (p + 1) * per)):
            raise AssertionError(f"mh[{p}]: backend {r['backend']}, mesh "
                                 f"{r['mesh']}, local {r['local']}")
        for tier in ("hot", "cold", "t"):
            for name, c in r[tier].items():
                if not same_rows(c["rows"], refs[name], name in ORDERED):
                    raise AssertionError(f"mh[{p}] {tier} {name}: rows != "
                                         f"numpy reference")
                key = f"{tier} {name}" if tier != "t" else f"T {name}"
                base = s1.get(key)
                if base is not None and not same_rows(
                        norm(c["rows"]), norm(base["rows"]),
                        name in ORDERED):
                    raise AssertionError(f"mh[{p}] {key}: rows != S = 1")
                cells.setdefault(key, []).append(c)
        for name, c in r["cold"].items():
            if c["launches"]["unpack_codes"] <= 0:
                raise AssertionError(f"mh[{p}] cold {name}: no K2 launch")
        for tier in ("hot", "cold"):
            if r[tier]["ck1"]["launches"]["remap_codes"] <= 0:
                raise AssertionError(f"mh[{p}] {tier} ck1: no K1 launch")
        bad = [k for k in r["k1_inputs"] + r["k2_inputs"]
               if k["max_abs_err"]]
        if bad or not r["k1_inputs"] or not r["k2_inputs"]:
            raise AssertionError(f"mh[{p}]: kernel inputs {bad}")
        fl_s1 = s1.get("fl_dense")
        if fl_s1 is not None and norm(r["fl"]["rows"]) != norm(
                fl_s1["rows"]):
            raise AssertionError(f"mh[{p}] fl_dense: != S = 1 after "
                                 "_norm")
    if {repr(sorted(r["fl"]["rows"], key=str)) for r in res} != \
            {repr(sorted(res[0]["fl"]["rows"], key=str))}:
        raise AssertionError("mh fl_dense: processes' bits differ")
    for key, cs in cells.items():
        if any(not same_rows(c["rows"], cs[0]["rows"], True) for c in cs):
            raise AssertionError(f"mh {key}: processes' rows differ")
        walls = ", ".join(f"{c['steady_s'] * 1e3:.1f}" for c in cs)
        base = s1.get(key)
        mesh = s1.get(f"S={MESH_S} {key}")
        log(f"mh {key}: rows equal in {len(cs)} processes and numpy; "
            f"steady {walls} ms a process"
            + (f" vs S = 1 {base['steady_s'] * 1e3:.1f} ms" if base
               else "")
            + (f", in-process S = {MESH_S} {mesh['steady_s'] * 1e3:.1f} ms"
               if mesh else ""))
    fl_s1 = s1.get("fl_dense")
    log("mh fl_dense: bit-identical in every process and run, == "
        "math.fsum after _norm; steady "
        + ", ".join(f"{r['fl']['steady_s'] * 1e3:.1f}" for r in res)
        + " ms a process"
        + (f" vs S = 1 {fl_s1['steady_s'] * 1e3:.1f} ms" if fl_s1 else ""))
    for r in res:
        log(f"mh[{r['pid']}]: peak device memory "
            + ", ".join(f"{k} {v:.2f} GiB" for k, v in r["peak_gib"].items())
            + f"; SF10 load {r['load_s']:.1f} s")
    log(f"mh: {nprocs} processes x {per} positions, backend {backend}, "
        f"{wall:.1f} s")
    launches = {"remap_codes": 0, "unpack_codes": 0}
    for r in res:
        for tier in ("hot", "cold", "t"):
            for c in r[tier].values():
                for k in launches:
                    launches[k] += c["launches"][k]
    return {"mh": {"launches": launches, "wall_s": wall,
                   "k1_inputs": [k for r in res for k in r["k1_inputs"]],
                   "k2_inputs": [k for r in res for k in r["k2_inputs"]]}}


DP_QUERIES = (("q1", None), ("q6", None), ("ck1", CK1))
_DP_COUNTERS = ("dataplane_queries_total", "dataplane_card_fragments_total",
                "cop_region_cpu_runs_total", "dataplane_bypass_total",
                "dataplane_failover_bypass_total",
                "dataplane_cold_reloads_total",
                "dataplane_replica_promotions_total")


def dp_member(pid: int, members: int, layout: str, rf: int, port: str,
              dp_dir: str, out_path: str) -> int:
    """One member of the `dp` phase: builds the SF10 lineitem from SEED,
    joins the coordinator, shards the table (replication factor `rf`,
    every partition persisted to `dp_dir`), waits for every member of
    `members`, then runs DP_ROUNDS
    rounds of Q1, Q6 and ck1 hot and DP_ROUNDS cold (the partitions'
    packable columns bit-packed), holds K1 and K2 against their plain
    versions on its inputs, writes its report to `out_path` and goes on
    with hot rounds until SIGTERM.  Each round prints its counters and
    its end on the host clock."""
    import pickle
    import signal

    os.environ.update({
        "TIDB_TPU_DATAPLANE_RF": str(rf), "TIDB_TPU_DATAPLANE_DIR": dp_dir,
        "TIDB_TPU_DISPATCH_CHUNK_ROWS": str(CHUNK_ROWS)})
    from tidb_tpu_torch import ops
    from tidb_tpu_torch.coord import activate_worker
    from tidb_tpu_torch.dataplane import activate_dataplane
    from tidb_tpu_torch.layout import hot_cap_bytes, set_hot_cap_bytes
    from tidb_tpu_torch.metrics import REGISTRY
    from tidb_tpu_torch.tpch_data import build_lineitem

    tag = f"dp[{pid}]"
    if layout == "share":
        ops.use_device("cuda")
        import torch

        torch.set_num_threads(max(1, (os.cpu_count() or 2) // members))
    else:
        _fleet_device(layout, pid, members)
    t0 = time.perf_counter()
    sess = build_lineitem(SF10_ROWS, seed=SEED)
    log(f"{tag}: SF10 load {time.perf_counter() - t0:.1f} s")
    dom = sess.domain
    tid = dom.catalog.info_schema().table("test", "lineitem").id
    plane = activate_worker(("127.0.0.1", int(port)), pid=pid,
                            devices=list(ops.device_ids()),
                            lease_s=DP_LEASE_S)
    dp = activate_dataplane(dom.storage, plane=plane, pid=pid)
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        v = plane.view()
        if v.formed and len(v.members) >= members \
                and len(v.addrs) >= members:
            break
        time.sleep(0.05)
    t0 = time.perf_counter()
    st = dp.shard_table(tid)
    log(f"{tag}: SHARDED loaded {len(st.loaded)}/{st.n_parts} partitions "
        f"in {time.perf_counter() - t0:.1f} s")
    plane.shared_put(f"dp_sharded_{pid}", 1)
    while time.monotonic() < deadline and not all(
            plane.shared_get(f"dp_sharded_{p}")[0]
            for p in range(members)):
        time.sleep(0.05)
    sess.execute("set tidb_use_tpu = 1")
    queries = [(n, _sql(n, q)) for n, q in DP_QUERIES]
    k1, k2 = _kernel_counts()

    def cnt():
        snap = REGISTRY.snapshot()
        return [snap.get(n, 0) for n in _DP_COUNTERS]

    def one_round(ref):
        c0 = cnt()
        t0 = time.perf_counter()
        rows = {name: sess.query(sql) for name, sql in queries}
        wall = time.perf_counter() - t0
        moved = dict(zip(("dp", "card", "cpu", "bypass", "fbypass",
                          "cold", "promote"),
                         (b - a for a, b in zip(c0, cnt()))))
        ok = ref is None or all(same_rows(rows[n], ref[n], n in ORDERED)
                                for n in rows)
        log(f"ROUND pid={pid} epoch={plane.current_epoch()} ok={int(ok)} "
            f"dp={int(moved['dp'])} card={int(moved['card'])} "
            f"cpu={int(moved['cpu'])} "
            f"bypass={int(moved['bypass'] + moved['fbypass'])} "
            f"cold={int(moved['cold'])} promote={int(moved['promote'])} "
            f"wall_ms={wall * 1e3:.1f} "
            f"t_end={time.time():.3f}")
        return rows, moved, wall, ok

    default_cap = hot_cap_bytes()
    seen_k1, restore_k1 = record_remap_inputs()
    seen_k2, restore = record_unpack_inputs()
    report = {"pid": pid, "rounds": {}}
    try:
        for tier in ("hot", "cold"):
            if tier == "cold":
                part = dom.storage.table(next(iter(st.loaded.values())))
                set_hot_cap_bytes(cold_cap(part))
                reset_device_state()
            k1.launches = k2.launches = 0
            ref = None
            walls, moves = [], []
            for _ in range(DP_ROUNDS):
                rows, moved, wall, ok = one_round(ref)
                ref = ref or rows
                walls.append(wall)
                moves.append(moved)
                if not ok:
                    raise AssertionError(f"{tag} {tier}: rows changed")
            eng = {n: engines(sess, q) for n, q in queries}
            report["rounds"][tier] = {
                "rows": ref, "walls": walls, "moved": moves, "engines": eng,
                "launches": {"remap_codes": k1.launches,
                             "unpack_codes": k2.launches}}
        report["k2_inputs"] = path_kernel_phase(seen_k2)
        report["k1_inputs"] = path_k1_phase(seen_k1)
    finally:
        restore()
        restore_k1()
    del seen_k1, seen_k2
    set_hot_cap_bytes(default_cap)
    reset_device_state()
    ref = report["rounds"]["hot"]["rows"]
    with open(out_path, "wb") as f:
        pickle.dump(report, f)
    log(f"REPORTED pid={pid}")
    stop = [False]
    signal.signal(signal.SIGTERM, lambda *_a: stop.__setitem__(0, True))
    end = time.monotonic() + FLEET_TIMEOUT_S
    while not stop[0] and time.monotonic() < end:
        one_round(ref)
    plane.leave()
    plane.stop()
    log(f"DRAINED pid={pid}")
    return 0


def _round_fields(line: str) -> dict:
    return {k: float(v) for k, v in re.findall(r"(\w+)=([-\d.]+)", line)}


def dp_phase(want: dict, members: int = DP_MEMBERS, rf: int = 1,
             layout: str = "share") -> dict:
    """The `dp` phase: the coordinator here, `members` members on the
    card ("share"; one a card: "cards"), the SF10 lineitem sharded with
    replication factor `rf`.  Every hot and cold
    round of every member must be served by the data plane (every
    statement counted on `dataplane_queries_total`, every partition
    fragment on the card, no host-engine run, no bypass) with rows equal
    to numpy, and K1 and K2 must have launched and matched their plain
    versions on the members' inputs.  Then the last member is
    killed (SIGKILL): the epoch must bump, the survivors take over its
    partitions (RF = 1: replayed from the persisted blocks,
    `dataplane_cold_reloads_total` moves; RF = 2: promoted replicas,
    `dataplane_replica_promotions_total` moves and no cold reload) and
    every survivor answer with parity through the data plane.  The time
    to recover runs from the kill to the end of member 0's first such
    round."""
    import pickle
    import shutil

    from tidb_tpu_torch.coord.plane import Coordinator

    os.makedirs(FLEET_DIR, exist_ok=True)
    dp_dir = os.path.join(FLEET_DIR, "dp")
    shutil.rmtree(dp_dir, ignore_errors=True)
    coord = Coordinator(lease_s=DP_LEASE_S, expect=members)
    coord.start()
    logs = [os.path.join(FLEET_DIR, f"dp{p}.log") for p in range(members)]
    outs = [os.path.join(FLEET_DIR, f"dp{p}.pkl") for p in range(members)]
    labels = [f"dp[{p}]" for p in range(members)]
    for path in outs:
        if os.path.exists(path):
            os.remove(path)
    procs = []
    t_start = time.perf_counter()

    def lines(p):
        with open(logs[p]) as f:
            return [ln.strip() for ln in f]

    def wait_for(pred, timeout_s, watch=None):
        """pred() within timeout_s; False at once when a watched
        process (default: every member) has exited."""
        end = time.monotonic() + timeout_s
        while time.monotonic() < end:
            if pred():
                return True
            if any(p.poll() is not None for p in watch or procs):
                return pred()
            time.sleep(0.1)
        return pred()

    try:
        for p in range(members):
            procs.append(_spawn("dp", p, [members, layout, rf, coord.port,
                                          dp_dir, outs[p]], logs[p]))
        if not wait_for(lambda: all(os.path.exists(o) for o in outs),
                        FLEET_TIMEOUT_S):
            raise AssertionError("dp: members did not report")
        reports = []
        for path in outs:
            with open(path, "rb") as f:
                reports.append(pickle.load(f))
        victim = members - 1
        e0 = coord.view().epoch
        t_kill = time.time()
        procs[victim].kill()
        t0 = time.perf_counter()
        if not wait_for(lambda: victim not in coord.view().members,
                        4 * DP_LEASE_S + 10, watch=procs[:victim]):
            raise AssertionError("dp: the killed member was not expired")
        expired_s = time.perf_counter() - t0
        e1 = coord.view().epoch

        def recovered(p):
            """Member p's first round at the new epoch served whole by
            the data plane with parity."""
            for ln in lines(p):
                if not ln.startswith("ROUND"):
                    continue
                f = _round_fields(ln)
                if f["epoch"] >= e1 and f["ok"] == 1 \
                        and f["dp"] == len(DP_QUERIES) and f["cpu"] == 0 \
                        and f["bypass"] == 0:
                    return f
            return None

        if not wait_for(lambda: all(recovered(p) is not None
                                    for p in range(victim)), 300,
                        watch=procs[:victim]):
            raise AssertionError("dp: the survivors did not answer through "
                                 "the data plane at the new epoch")
        rec = recovered(0)
        recover_s = rec["t_end"] - t_kill
        for p in procs[:victim]:
            p.send_signal(15)
        for p in procs[:victim]:
            p.wait(timeout=120)
    finally:
        _stop(procs)
        coord.stop()
        for lb, lp in zip(labels, logs):
            _echo(lb, lp)
    # every survivor's rounds at the new epoch: the takeover happens on
    # whichever survivor held the lost member's replicas
    post = [f for p in range(victim) for ln in lines(p)
            if ln.startswith("ROUND")
            for f in [_round_fields(ln)] if f["epoch"] >= e1]
    bad = [ln for p in range(members) for ln in lines(p)
           if ln.startswith("ROUND") and "ok=0" in ln]
    if bad:
        raise AssertionError(f"dp: rounds without parity: {bad[:3]}")
    cold_n = sum(f["cold"] for f in post)
    promoted = sum(f["promote"] for f in post)
    if e1 <= e0 or not post or (cold_n <= 0 if rf == 1
                                else promoted <= 0 or cold_n):
        raise AssertionError(f"dp: epoch {e0} -> {e1}; RF {rf} takeover "
                             f"cold {cold_n}, promoted {promoted}: "
                             f"{post[:3]}")
    refs = {"q1": want["q1"], "q6": want["q6"], "ck1": want["ck1"]}
    launches = {"remap_codes": 0, "unpack_codes": 0}
    for r in reports:
        p = r["pid"]
        for tier, rd in r["rounds"].items():
            for name, rows in rd["rows"].items():
                if not same_rows(rows, refs[name], name in ORDERED):
                    raise AssertionError(f"dp[{p}] {tier} {name}: rows != "
                                         "numpy reference")
            for m in rd["moved"]:
                if m["dp"] != len(DP_QUERIES) or m["card"] <= 0 \
                        or m["cpu"] or m["bypass"] or m["fbypass"]:
                    raise AssertionError(f"dp[{p}] {tier}: round {m}")
            for name, eng in rd["engines"].items():
                if not eng or not all("engine:dataplane" in e for e in eng):
                    raise AssertionError(f"dp[{p}] {tier} {name}: route "
                                         f"{eng}")
            for k in launches:
                launches[k] += rd["launches"][k]
            log(f"dp[{p}] {tier}: {DP_ROUNDS} rounds of "
                f"{len(DP_QUERIES)} statements through the data plane, "
                f"rows == numpy; round walls "
                + ", ".join(f"{w * 1e3:.1f}" for w in rd["walls"])
                + f" ms; fragments on the card "
                f"{[int(m['card']) for m in rd['moved']]}; launches "
                f"{rd['launches']}")
        if r["rounds"]["cold"]["launches"]["unpack_codes"] <= 0 or \
                r["rounds"]["hot"]["launches"]["remap_codes"] <= 0:
            raise AssertionError(f"dp[{p}]: launches {r['rounds']}")
        bad = [k for k in r["k1_inputs"] + r["k2_inputs"]
               if k["max_abs_err"]]
        if bad:
            raise AssertionError(f"dp[{p}]: kernel inputs {bad}")
    wall = time.perf_counter() - t_start
    log(f"dp: {members} members, RF {rf}; member {victim} killed at "
        f"epoch {e0}; expired after {expired_s:.2f} s (lease {DP_LEASE_S} "
        f"s), epoch {e1}; the survivors took over (cold reloads "
        f"{int(cold_n)}, replica promotions {int(promoted)}) and answered "
        f"through the data plane with parity; time to recover (member 0) "
        f"{recover_s:.2f} s; "
        f"first recovered round {rec['wall_ms']:.1f} ms; phase {wall:.1f} s")
    return {"dp": {"launches": launches, "recover_s": recover_s,
                   "wall_s": wall,
                   "k1_inputs": [k for r in reports for k in r["k1_inputs"]],
                   "k2_inputs": [k for r in reports for k in r["k2_inputs"]]}}


def fleet_worker(argv) -> int:
    kind, pid = argv[0], int(argv[1])
    if kind == "mh":
        return mh_worker(pid, int(argv[2]), argv[3], argv[4], argv[5])
    if kind == "dp":
        return dp_member(pid, int(argv[2]), argv[3], int(argv[4]), argv[5],
                         argv[6], argv[7])
    raise SystemExit(f"unknown fleet worker {kind}")


# ---------------------------------------------------------------------------
# the lint phase: the kernel family of the port's lint on the card
# ---------------------------------------------------------------------------

def lint_phase() -> dict:
    """The canonical program corpus of `tidb_tpu_torch.lint.kernelcheck`
    on the card, against the `cuda` section of the lint baseline.  Fails
    on any finding.  `launches` counts K1 and K2 in the programs of the
    path (the kernels' own parity calls, `cuda-*`, are comparisons and do
    not count)."""
    from tidb_tpu_torch.lint.baseline import kernel_stats, load_baseline
    from tidb_tpu_torch.lint.kernelcheck import (CUDA_KERNELS, compare_stats,
                                                 measure_kernels)

    t0 = time.perf_counter()
    stats, findings = measure_kernels("cuda")
    findings += compare_stats(stats, kernel_stats(load_baseline(), "cuda"))
    wall = time.perf_counter() - t0
    for name, st in stats.items():
        if name != "__signatures__":
            log(f"lint {name}: ops {st['ops']}, i64_ops {st['i64_ops']}, "
                f"K1 {st['k1']}, K2 {st['k2']}")
    log(f"lint: corpus ProgramCache entries "
        f"{stats['__signatures__']['max']}; {len(findings)} finding(s); "
        f"phase {wall:.1f} s")
    log("lint stats: " + json.dumps(stats, sort_keys=True))
    if findings:
        raise AssertionError("lint: " + "; ".join(
            f.render() for f in findings[:8]))
    path = [st for n, st in stats.items()
            if n not in CUDA_KERNELS and n != "__signatures__"]
    return {"lint": {"launches": {
        "remap_codes": sum(st["k1"] for st in path),
        "unpack_codes": sum(st["k2"] for st in path)},
        "wall_s": wall, "stats": stats}}


def lint_only(card: str) -> int:
    """`--lint-only`: build the kernels and run the lint phase alone."""
    import torch

    from tidb_tpu_torch.copr.cuda import build_all

    log(f"kernel build: {build_all()}")
    lint = lint_phase()
    print(json.dumps({"lint": lint["lint"]["launches"],
                      "stats": lint["lint"]["stats"]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def kernel_entry(name: str, launches: int, on_path: list,
                 pick_from: list) -> dict:
    """One kernel's entry of the `kernels` line: the numbers measured on
    the input of `pick_from` (the S = 1 cells' inputs, with their S = 1
    calls) the path launched most (the larger n on a tie); the error
    over every input."""
    from tidb_tpu_torch.copr.cuda import KERNELS

    _fn, _plain, source, replaces = KERNELS[name]
    k = max(pick_from, key=lambda r: (r["calls"], r["n"]))
    entry = {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in on_path),
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": "bytes", "library_ms": k.get("library_ms"),
        "n": k["n"],
    }
    for extra in ("bits", "out_dtype", "unfused_ms", "code", "map", "cap"):
        if extra in k:
            entry[extra] = k[extra]
    return entry


def main(argv) -> int:
    import torch

    profiling = "--profile" in argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import tidb_tpu_torch  # noqa: F401  (fails outside a checkout)
    if argv[:1] == ["--fleet-worker"]:
        return fleet_worker(argv[1:])
    from tidb_tpu_torch import ops
    from tidb_tpu_torch.copr.cuda import build_all, ptxas_report
    from tidb_tpu_torch.layout import (autotuner, hot_cap_bytes,
                                       set_hot_cap_bytes)
    from tidb_tpu_torch.metrics import REGISTRY
    from tidb_tpu_torch.tpch_data import (LINEITEM_Q1, LINEITEM_Q6,
                                          build_lineitem)

    t_start = time.perf_counter()
    default_cap = hot_cap_bytes()
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}"
        f", count {torch.cuda.device_count()}")
    ops.use_device("cuda")
    if "--lint-only" in argv:
        return lint_only(card)
    os.environ["TIDB_TPU_DISPATCH_CHUNK_ROWS"] = str(CHUNK_ROWS)

    t0 = time.perf_counter()
    build_secs = build_all()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in build_secs.items())})")
    for name in build_secs:
        for fn, regs, st, ld in ptxas_report(name):
            # the template's name and arguments, not the parameter list
            fn = re.sub(r"^void |<unnamed>::|\(anonymous namespace\)::"
                        r"|\([^()]*\)$", "", fn)
            log(f"  ptxas {name}: {fn}: {regs} registers, "
                f"spill stores {st} B, spill loads {ld} B")

    kernel_phase()
    k1_phase()

    sf1 = sf1_host_check()
    t0 = time.perf_counter()
    want18 = q18_reference(SF1_ROWS)
    log(f"SF1 numpy reference: {time.perf_counter() - t0:.1f} s")
    q18 = q18_cells(sf1, SF1_ROWS, want18)
    del sf1
    gc.collect()
    reset_device_state()

    t0 = time.perf_counter()
    sess = build_lineitem(SF10_ROWS, seed=SEED)
    load_s = time.perf_counter() - t0
    log(f"SF10 load: {SF10_ROWS} rows in {load_s:.1f} s")
    d = sess.domain
    table = d.storage.table(d.catalog.info_schema().table(
        "test", "lineitem").id)

    t0 = time.perf_counter()
    want = numpy_reference(SF10_ROWS)
    log(f"numpy reference: {time.perf_counter() - t0:.1f} s")

    both = [("q1", LINEITEM_Q1), ("q6", LINEITEM_Q6), ("ck1", CK1),
            ("ck2", CK2)]
    hot_only = [("sa", SA), ("tn", TN), ("mf", MF)]

    # hot deployment: every column resident, no unpack launch
    fail0 = failure_counters()
    seen_k1, restore_k1 = record_remap_inputs()
    try:
        hot = run_queries(sess, "hot", SF10_ROWS, both + hot_only)
    finally:
        restore_k1()
    check_rows("hot", hot, want)
    for name, r in hot.items():
        if r["launches"]["unpack_codes"] != 0:
            raise AssertionError(f"hot {name}: unpack launches "
                                 f"{r['launches']}")
        if (r["launches"]["remap_codes"] > 0) != (name in ("ck1", "ck2")):
            raise AssertionError(f"hot {name}: remap launches "
                                 f"{r['launches']}")
    if profiling:
        profile_queries(sess, "hot", both + hot_only)

    # cold deployment: the packable columns bit-packed on the card
    reset_device_state()
    cap = cold_cap(table)
    set_hot_cap_bytes(cap)
    log(f"cold: hot-tier cap {cap} bytes (table wire bytes "
        f"{autotuner._table_wire_bytes(table)})")
    hits0 = REGISTRY.snapshot().get("layout_cold_hits_total", 0)
    seen, restore = record_unpack_inputs()
    seen_k1_cold, restore_k1 = record_remap_inputs()
    try:
        cold = run_queries(sess, "cold", SF10_ROWS, both)
    finally:
        restore()
        restore_k1()
    hits1 = REGISTRY.snapshot().get("layout_cold_hits_total", 0)
    for r in sess.query(
            "select column_name, encoding, packed_bits, tier, tile_bucket"
            " from information_schema.tidb_tpu_column_layout"):
        log(f"  layout: {r}")
    cold_cols = {r[0] for r in sess.query(
        "select column_name from information_schema.tidb_tpu_column_layout"
        " where tier = 'cold'")}
    if not cold_cols >= {"l_returnflag", "l_linestatus", "l_discount",
                         "l_tax"}:
        raise AssertionError(f"cold: cold columns {cold_cols}")
    check_rows("cold", cold, want)
    for name, r in cold.items():
        if r["launches"]["unpack_codes"] <= 0:
            raise AssertionError(f"cold {name}: the unpack kernel never "
                                 "launched")
        if (r["launches"]["remap_codes"] > 0) != (name in ("ck1", "ck2")):
            raise AssertionError(f"cold {name}: remap launches "
                                 f"{r['launches']}")
    if hits1 <= hits0:
        raise AssertionError("cold: no cold-tier hit")
    fail1 = failure_counters()
    if fail1 != fail0:
        raise AssertionError(f"fallback counters moved: {fail0} -> {fail1}")
    log(f"cold: rows == hot rows == numpy reference; cold hits "
        f"{hits1 - hits0}; fallback counters unchanged {fail1}")
    if profiling:
        profile_queries(sess, "cold", both)

    # the MPP exchange engine over the SF10 lineitem, at the default
    # hot cap (MPP sides read the hot tier)
    reset_device_state()
    set_hot_cap_bytes(default_cap)
    ma10, seen_k1_mpp = ma10_phase(sess, profiling)

    # the mesh: MESH_S positions on the one card, then mA10 at each of
    # MESH_MA10_S; K1's and K2's inputs there join the path's inputs
    mesh, seen_k1_mesh, seen_k2_mesh = mesh_phase(
        sess, table, want, hot, cold, profiling)
    ma10_m, seen_k1_ma10m = ma10_mesh(
        sess, ma10, {"mA10": ma10["mA10"]["rows"]}, profiling)
    mesh.update(ma10_m)

    # the join cells
    del sess, table, d
    gc.collect()
    reset_device_state()
    joins, seen_join = join_phase(profiling)
    for key, rec in seen_join.items():
        if key in seen:
            seen[key][0] += rec[0]
        else:
            seen[key] = rec
    fl = float_phase(profiling)
    # the fleet phases: processes on the one card (mh), the sharded data
    # plane (dp); the same cells' rows and walls in this process beside
    s1 = {f"{tier} {k}": v for tier, res in (("hot", hot), ("cold", cold))
          for k, v in res.items()}
    s1.update({f"S={MESH_S} {k[len(f'S={MESH_S} '):]}": v
               for k, v in mesh.items() if k.startswith(f"S={MESH_S} ")})
    for n in MH_T:
        s1[f"T {n}"] = joins[f"T {n}"]
        s1[f"S={MESH_S} T {n}"] = joins[f"T S={MESH_S} {n}"]
    s1["fl_dense"] = fl["fl"]["cells"]["fl_dense"]
    fleet = mh_phase(want, s1)
    fleet.update(dp_phase(want))
    # the lint phase last: its epoch guard bumps the membership epoch
    reset_device_state()
    lint = lint_phase()
    # the S = 1 cells' calls a K2 input (bits, n): they pick the
    # headline input of the kernels line, as before the mesh cells
    s1_k2 = {}
    for key, rec in seen.items():
        s1_k2[key[:2]] = s1_k2.get(key[:2], 0) + rec[0]
    s1_k1 = {}
    for key, rec in (list(seen_k1.items()) + list(seen_k1_cold.items())
                     + list(seen_k1_mpp.items())):
        s1_k1[key] = s1_k1.get(key, 0) + rec[0]
    for key, rec in seen_k2_mesh.items():
        if key in seen:
            seen[key][0] += rec[0]
        else:
            seen[key] = rec
    on_path_k2 = path_kernel_phase(seen)
    for key, rec in (list(seen_k1_cold.items()) + list(seen_k1_mpp.items())
                     + list(seen_k1_mesh.items())
                     + list(seen_k1_ma10m.items())):
        if key in seen_k1:
            seen_k1[key][0] += rec[0]
        else:
            seen_k1[key] = rec
    on_path_k1 = path_k1_phase(seen_k1)

    cells = (list(hot.values()) + list(cold.values()) + list(q18.values())
             + list(ma10.values()) + list(mesh.values())
             + list(joins.values()) + list(fl.values())
             + list(fleet.values()) + list(lint.values()))
    k1_launches = sum(r["launches"]["remap_codes"] for r in cells)
    k2_launches = sum(r["launches"]["unpack_codes"] for r in cells)
    # the launches of the mesh cells alone (S = MESH_S, and mA10 at
    # each of MESH_MA10_S), and the inputs there
    mesh_k1 = sum(r["launches"]["remap_codes"] for r in mesh.values())
    mesh_k2 = sum(r["launches"]["unpack_codes"] for r in mesh.values())
    if mesh_k1 <= 0 or mesh_k2 <= 0:
        raise AssertionError(f"mesh: K1 {mesh_k1}, K2 {mesh_k2} launches")
    k1 = kernel_entry("remap_codes", k1_launches, on_path_k1, [
        dict(r, calls=s1_k1[key]) for r in on_path_k1
        for key in [(f"torch.{r['code']}", f"torch.{r['map']}", r["cap"],
                     r["n"])] if key in s1_k1])
    # K1 on the MPP path's input too: mA10's joined rows
    mpp_key = next(iter(seen_k1_mpp))
    k1_mpp = next(r for r in on_path_k1 if r["n"] == mpp_key[3]
                  and r["code"] == mpp_key[0][6:]
                  and r["cap"] == mpp_key[2])
    k1["mpp_input"] = {k: k1_mpp[k] for k in (
        "n", "code", "map", "cap", "calls", "ms", "plain_ms", "bound_ms",
        "library_ms", "max_abs_err")}
    k1["mpp_launches"] = ma10["mA10"]["launches"]["remap_codes"]
    k2 = kernel_entry("unpack_codes", k2_launches, on_path_k2, [
        dict(r, calls=s1_k2[(r["bits"], r["n"])]) for r in on_path_k2
        if (r["bits"], r["n"]) in s1_k2])
    mesh_keys = {"remap_codes": (set(seen_k1_mesh) | set(seen_k1_ma10m),
                                 lambda r, k: (r["code"], r["map"],
                                               r["cap"], r["n"])
                                 == (k[0][6:], k[1][6:], k[2], k[3])),
                 "unpack_codes": (set(seen_k2_mesh),
                                  lambda r, k: (r["bits"], r["n"])
                                  == (k[0], k[1]))}
    for entry, launches, on_path in ((k1, mesh_k1, on_path_k1),
                                     (k2, mesh_k2, on_path_k2)):
        keys, match = mesh_keys[entry["name"]]
        rows = [r for r in on_path if any(match(r, k) for k in keys)]
        entry["mesh_launches"] = launches
        entry["mesh_inputs"] = [{x: r.get(x) for x in (
            "n", "bits", "code", "map", "cap", "calls", "ms", "plain_ms",
            "bound_ms", "max_abs_err") if x in r} for r in rows]
        if not rows or any(r["max_abs_err"] for r in rows):
            raise AssertionError(f"{entry['name']}: mesh inputs {rows}")
    # the fleet workers' launches (counted in each worker over its
    # cells) and their inputs, each held against the plain version there
    for entry, key, inputs in ((k1, "remap_codes", "k1_inputs"),
                               (k2, "unpack_codes", "k2_inputs")):
        entry["fleet_launches"] = {
            ph: r["launches"][key] for ph, r in fleet.items()}
        entry["fleet_inputs"] = [{x: r.get(x) for x in (
            "n", "bits", "code", "map", "cap", "calls", "max_abs_err")
            if x in r} for ph in fleet for r in fleet[ph][inputs]]
        if any(not v for v in entry["fleet_launches"].values()):
            raise AssertionError(f"{entry['name']}: fleet launches "
                                 f"{entry['fleet_launches']}")
    for entry, key in ((k1, "remap_codes"), (k2, "unpack_codes")):
        entry["lint_launches"] = lint["lint"]["launches"][key]
    kernels = {"kernels": [k1, k2]}
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
