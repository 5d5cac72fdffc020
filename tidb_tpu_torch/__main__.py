"""tidb-tpu server entry point of the torch port (tidb-server/main.go:152
analog).

    python -m tidb_tpu_torch --host 127.0.0.1 --port 4000

Boots a Domain (storage + catalog + stats), then serves the MySQL wire
protocol.  The coprocessor runs on the CUDA card (`--engine gpu`, the
default); `--engine cpu` routes every statement through the host engine
and pins the package's device to the CPU, so the host is used only when
asked for.  Checkpoint/resume: --data-dir makes the store durable —
catalog JSON on DDL, base-block snapshots on load/compact, a
committed-delta log on every commit; boot reloads all of it
(store/persist.py).

With TIDB_TPU_COORDINATOR=host:port (and TIDB_TPU_NUM_PROCESSES,
TIDB_TPU_PROCESS_ID; TIDB_TPU_COORD_ADDR for the coordination plane)
the process first joins the multi-process mesh, before any statement
runs (`copr.parallel._maybe_init_multihost`).  Every process of the
mesh must then receive the same statements in the same order (SPMD):
a process runs one mesh statement at a time (`ops.program`), and
processes that issue different statements fail them with
`CollectiveError` instead of mixing their results.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser("tidb-tpu")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=4000)
    ap.add_argument("--data-dir", default="")
    ap.add_argument("--status-port", type=int, default=10080,
                    help="HTTP /metrics + /status port (0 disables)")
    ap.add_argument("--engine", default="gpu", choices=["gpu", "cpu"],
                    help="default coprocessor engine routing")
    args = ap.parse_args(argv)

    from . import ops
    from .server import StatusServer, serve_forever
    from .session import Domain

    # no CUDA device and no --engine cpu: fail here, not at a query
    ops.use_device("cuda" if args.engine == "gpu" else "cpu")
    # the multi-process mesh forms before the first statement; no-op
    # without TIDB_TPU_COORDINATOR
    from .copr.parallel import _maybe_init_multihost

    _maybe_init_multihost()
    domain = Domain(data_dir=args.data_dir or None)
    if args.engine == "cpu":
        domain.global_vars["tidb_use_tpu"] = "0"
    if args.status_port:
        StatusServer(domain, args.host, args.status_port).start()
    serve_forever(args.host, args.port, domain)


if __name__ == "__main__":
    main()
