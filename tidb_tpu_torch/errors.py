"""Error taxonomy, mirroring the reference's user-visible error classes.

Reference: TiDB surfaces typed errors (parser, planner, executor, kv) with MySQL
error codes. We keep a small hierarchy; codes follow MySQL where meaningful.
"""

from __future__ import annotations


class TiDBTPUError(Exception):
    """Base class for all framework errors."""

    code: int = 1105  # ER_UNKNOWN_ERROR


class ParseError(TiDBTPUError):
    code = 1064  # ER_PARSE_ERROR

    def __init__(self, msg: str, line: int = 0, col: int = 0):
        self.line, self.col = line, col
        loc = f" near line {line}:{col}" if line else ""
        super().__init__(f"You have an error in your SQL syntax{loc}: {msg}")


class PlanError(TiDBTPUError):
    code = 1105


class UnknownTableError(TiDBTPUError):
    code = 1146  # ER_NO_SUCH_TABLE

    def __init__(self, name: str):
        super().__init__(f"Table '{name}' doesn't exist")


class UnknownColumnError(TiDBTPUError):
    code = 1054  # ER_BAD_FIELD_ERROR

    def __init__(self, name: str, where: str = "field list"):
        super().__init__(f"Unknown column '{name}' in '{where}'")


class UnknownDatabaseError(TiDBTPUError):
    code = 1049

    def __init__(self, name: str):
        super().__init__(f"Unknown database '{name}'")


class TableExistsError(TiDBTPUError):
    code = 1050

    def __init__(self, name: str):
        super().__init__(f"Table '{name}' already exists")


class AmbiguousColumnError(TiDBTPUError):
    code = 1052

    def __init__(self, name: str):
        super().__init__(f"Column '{name}' in field list is ambiguous")


class TypeError_(TiDBTPUError):
    """Type-system error (named with trailing underscore to avoid shadowing)."""

    code = 1105


class OverflowError_(TiDBTPUError):
    code = 1264  # ER_WARN_DATA_OUT_OF_RANGE

    def __init__(self, typ: str, value):
        super().__init__(f"{typ} value is out of range: {value!r}")


class DivisionByZeroError(TiDBTPUError):
    code = 1365


class ExecutorError(TiDBTPUError):
    code = 1105


class DeviceUnavailableError(ExecutorError):
    """The device the engine runs on (CUDA unless the CPU was asked for
    with `ops.use_device("cpu")`) is absent: the statement fails instead
    of quietly running on the host."""


class CollectiveError(ExecutorError):
    """A collective of a mesh that spans processes (torch.distributed)
    failed or timed out: the statement fails with it; no process falls
    back to running alone."""


class KVError(TiDBTPUError):
    code = 1105


class TxnConflictError(KVError):
    """Write-write conflict detected at commit (optimistic 2PC)."""

    code = 9007  # TiKV write conflict

    def __init__(self, key=None):
        super().__init__(f"Write conflict on key {key!r}, txn must retry")


class SchemaChangedError(TxnConflictError):
    """DDL touched a written table between txn start and commit
    (domain/schema_validator.go + session.go checkSchemaValidity analog).
    Subclasses TxnConflictError so autocommit DML retries transparently
    under the new schema."""

    code = 8028  # ErrInfoSchemaChanged

    def __init__(self, msg="Information schema is changed during the "
                 "transaction; please retry"):
        KVError.__init__(self, msg)


class TxnAbortedError(KVError):
    code = 1105


class LockedError(KVError):
    """Key is locked by another in-flight transaction (Percolator lock)."""

    code = 9007

    def __init__(self, key=None, owner_ts: int = 0):
        self.key, self.owner_ts = key, owner_ts
        super().__init__(f"Key {key!r} locked by txn start_ts={owner_ts}")


class DeadlockError(KVError):
    """Pessimistic lock wait would close a wait-for cycle; the requesting
    txn is chosen as victim (util/deadlock/deadlock.go policy)."""

    code = 1213  # ER_LOCK_DEADLOCK

    def __init__(self):
        super().__init__(
            "Deadlock found when trying to get lock; try restarting "
            "transaction")


class LockWaitTimeoutError(KVError):
    code = 1205  # ER_LOCK_WAIT_TIMEOUT

    def __init__(self):
        super().__init__("Lock wait timeout exceeded; try restarting "
                         "transaction")


class RegionError(KVError):
    """Stale region epoch / not leader — caller must refresh routing and retry.

    Reference: store/tikv/region_request.go:281 onRegionError.
    """

    code = 9005

    def __init__(self, msg: str = "stale region epoch"):
        super().__init__(msg)


class QueryKilledError(ExecutorError):
    code = 1317  # ER_QUERY_INTERRUPTED

    def __init__(self):
        super().__init__("Query execution was interrupted")


class MaxExecutionTimeExceeded(QueryKilledError):
    """Statement ran past max_execution_time; the scope's deadline fired
    at a host-side seam (expensivequery.go's kill, enforced in-line)."""

    code = 3024  # ER_QUERY_TIMEOUT

    def __init__(self):
        ExecutorError.__init__(
            self, "Query execution was interrupted, maximum statement "
                  "execution time exceeded")


class ServerShutdownError(QueryKilledError):
    """Statement cancelled by graceful drain: it outlived the drain
    budget after SIGTERM/shutdown() stopped the listener."""

    code = 1053  # ER_SERVER_SHUTDOWN

    def __init__(self):
        ExecutorError.__init__(self, "Server shutdown in progress")


class ServerOverloadedError(TiDBTPUError):
    """Fast admission rejection: the bounded executor queue is full or
    the statement waited past the queue deadline (the server's front
    door sheds load instead of queueing unboundedly)."""

    code = 1040  # ER_CON_COUNT_ERROR family: resource exhaustion

    def __init__(self, what: str = "admission queue full"):
        super().__init__(f"Server overloaded: {what}")


class ResourceGroupThrottled(TiDBTPUError):
    """Typed retriable admission rejection: the statement's resource
    group has exhausted its RU (device-millisecond) budget and is not
    burstable, and the bounded in-line wait for the next refill also
    expired.  Clients retry with backoff — the group refills every
    second, so the error is transient by construction (TiDB's
    resource-control ErrResourceGroupThrottled analog)."""

    code = 8252  # ErrResourceGroupQueryRunawayQuarantine family

    def __init__(self, group: str, wait_ms: float = 0.0):
        self.group = group
        self.wait_ms = wait_ms
        super().__init__(
            f"Resource group '{group}' exhausted its RU budget "
            f"(waited {wait_ms:.0f}ms for refill); retry with backoff")


class MemoryQuotaExceededError(ExecutorError):
    """OOM action 'cancel' — reference util/memory/action.go PanicOnExceed."""

    code = 8175

    def __init__(self, quota: int, used: int):
        super().__init__(
            f"Out Of Memory Quota! used={used} bytes, quota={quota} bytes"
        )


class PrivilegeError(TiDBTPUError):
    code = 1142  # ER_TABLEACCESS_DENIED_ERROR

    def __init__(self, priv: str, user: str, obj: str):
        super().__init__(f"{priv} command denied to user '{user}' for '{obj}'")
