"""Per-position tensors and the cross-shard merge of the mesh.

A mesh of S positions runs one program per shard, each on its own
position's device (`ops.mesh_devices`).  What a shard holds travels as
a `Shards` tuple, one tensor per position in shard order.  The
collectives merge in a fixed order, so a merge of float partials has
the same bits on every run at a fixed S and chunking:

- `psum`: a left fold over positions 0..S-1;
- `on_positions`: one operand on every position (one copy per distinct
  device, shared by the positions that device holds).

When the mesh spans processes (`ops.process_count() > 1`, one
torch.distributed group), a per-shard list holds None at every
position of another process, and each process runs only its own
shards.  Then:

- `gather_shards` fills in every other process's parts (callers fold
  the gathered list with `psum` / `gather0` in global shard order on
  every process: never an ``all_reduce``, whose order is the
  backend's, and float merges must keep the single-process bits);
- `agree` hands every process process 0's value of a host decision
  (the chunk budget, the mesh, the layout), so all of them issue the
  same collectives in the same order;
- `all_to_all` moves the blocks of the MPP exchange between processes;
  blocks between positions of one process stay copies.

Every process must issue the same collectives in the same order.  A
statement's collectives run inside one `program`: one per process at a
time (`_PROGRAM_LOCK`), each collective headed by (op, program, step)
so that processes at different collectives raise `CollectiveError`
together instead of reading each other's bytes, and closed by one more
collective.  A process that fails between two collectives sends an
abort in place of its next one, so the others' pending collective (at
the latest the closing one) raises for the same statement and the
fleet stays in step.

Transport: `gather_shards` and `agree` pickle their parts on the host
and move them as one uint8 all_gather, on both backends (under nccl the
buffer is staged onto the card and back).  Only `all_to_all` moves card
tensors directly under nccl; ``gloo`` has no CUDA all_to_all, so its
blocks go through pinned host buffers: a fixed transport for that
backend, not a retry.  Every collective error or timeout raises
`CollectiveError` to the statement.
"""

from __future__ import annotations

import contextlib
import pickle
import threading
import zlib
from typing import Sequence

import numpy as np
import torch

from ..errors import CollectiveError
from ..util_concurrency import make_lock


class Shards(tuple):
    """One tensor per mesh position, in shard order (shard s lives on
    position s's device; None at a position of another process).
    `nbytes` counts each distinct tensor once: positions that share a
    device may share an operand."""

    @property
    def nbytes(self) -> int:
        seen, n = set(), 0
        for t in self:
            if t is not None and id(t) not in seen:
                seen.add(id(t))
                n += int(t.nbytes)
        return n


def first_local(parts: Sequence):
    """The first entry this process holds (not None)."""
    return next(x for x in parts if x is not None)


def on_positions(t: torch.Tensor, devices: Sequence) -> Shards:
    """`t` on every local position's device: one copy per distinct
    device (None where the position belongs to another process)."""
    copies = {}
    out = []
    for d in devices:
        if d is None:
            out.append(None)
            continue
        x = copies.get(d)
        if x is None:
            x = copies[d] = t if t.device == d else t.to(d)
        out.append(x)
    return Shards(out)


# ---------------------------------------------------------------------------
# across processes
# ---------------------------------------------------------------------------


def _multi() -> bool:
    from . import process_count

    return process_count() > 1


def _dist():
    import torch.distributed as dist

    return dist


def _comm_device() -> torch.device:
    """Where the collectives' buffers live: this process's card under
    nccl (named, not the calling thread's current device: statements
    run on other threads, whose current device is card 0, and nccl keys
    its communicators on the buffers' device), the host (pinned
    staging) under gloo."""
    from . import device

    dist = _dist()
    if dist.get_backend() == "nccl":
        d = device()
        return d if d.index is not None else torch.device(
            "cuda", torch.cuda.current_device())
    return torch.device("cpu")


@contextlib.contextmanager
def _collective(what: str, nbytes: int = 0):
    """Count one collective; turn its failure or timeout into the typed
    `CollectiveError` the statement receives."""
    from ..metrics import REGISTRY

    REGISTRY.inc("dist_collectives_total")
    REGISTRY.inc("dist_collective_bytes_total", nbytes)
    try:
        yield
    except CollectiveError:
        raise
    except Exception as e:  # noqa: BLE001 - the backend's own types
        REGISTRY.inc("dist_collective_errors_total")
        raise CollectiveError(
            f"{what} across {_dist().get_world_size()} processes failed: "
            f"{type(e).__name__}: {e}") from e


def _staged(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """`t` on the collective's device (through pinned memory from a
    card to the host)."""
    if t.device == dev:
        return t
    if dev.type == "cpu" and t.device.type == "cuda":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host
    return t.to(dev)


# one statement's collectives at a time per process: two statements'
# collectives interleaved on one group pair up in a different order on
# each process
_PROGRAM_LOCK = make_lock("ops.collective:_PROGRAM_LOCK")

#: header of every host collective: payload bytes, op, program, step,
#: abort flag
_HDR = 5


class _Program(threading.local):
    depth = 0
    name = ""
    tag = 0
    step = 0


_PROG = _Program()


def _crc(s: str) -> int:
    return zlib.crc32(s.encode())


@contextlib.contextmanager
def program(name: str, key: str = ""):
    """One statement's collectives across processes (`name` and `key`,
    say the request's plan, tag each of them): held under the
    per-process `_PROGRAM_LOCK`, and closed by one collective that every
    process issues.  An error this process raises between collectives
    (a shard's device fault, OOM, KILL, a quota) first sends an abort
    in place of its next collective: the others' pending collective
    raises `CollectiveError` for the same statement.  A `CollectiveError`
    was raised at a collective on every process alike (or the group is
    broken) and sends nothing.  Nested programs belong to the outermost;
    one process: a no-op."""
    st = _PROG
    if st.depth or not _multi():
        st.depth += 1
        try:
            yield
        finally:
            st.depth -= 1
        return
    with _PROGRAM_LOCK:
        st.depth, st.name, st.tag, st.step = 1, name, _crc(f"{name}|{key}"), 0
        try:
            yield
        except CollectiveError:
            raise
        except BaseException as e:
            try:
                _exchange("abort", f"{type(e).__name__}: {e}"[:4096]
                          .encode(), abort=True)
            except CollectiveError:
                pass  # the group is gone too: the statement gets `e`
            raise
        else:
            _exchange("end")
        finally:
            st.depth, st.name, st.tag, st.step = 0, "", 0, 0


def _exchange(op: str, buf: bytes = b"", abort: bool = False) -> list:
    """Every process's byte string, in rank order: the headers first
    (payload size, op, program, step, abort), then the payloads padded
    to the largest.  Every process holds the same headers, so all reach
    the same verdict: a peer's abort, or processes at different
    collectives, raise `CollectiveError` everywhere at this step."""
    from . import process_index

    dist = _dist()
    P = dist.get_world_size()
    dev = _comm_device()
    st = _PROG
    # steps count within a program; a collective outside any (a
    # barrier, the join's position count) is step 0 of program 0
    step = st.step
    if st.depth:
        st.step += 1
    with _collective(f"{op} (header)", 8 * _HDR):
        hdr = torch.tensor([len(buf), _crc(op), st.tag, step, int(abort)],
                           dtype=torch.int64, device=dev)
        hdrs = torch.empty(P * _HDR, dtype=torch.int64, device=dev)
        dist.all_gather_into_tensor(hdrs, hdr)
        hdrs = hdrs.reshape(P, _HDR).cpu().tolist()
    m = max(h[0] for h in hdrs)
    blobs = [b""] * P
    if m:
        src = torch.zeros(m, dtype=torch.uint8,
                          pin_memory=dev.type == "cpu"
                          and torch.cuda.is_available())
        if buf:
            src[:len(buf)] = torch.frombuffer(bytearray(buf),
                                              dtype=torch.uint8)
        with _collective(op, m * P):
            out = torch.empty(P * m, dtype=torch.uint8, device=dev)
            dist.all_gather_into_tensor(out, src.to(dev))
            flat = out.cpu().numpy()
        blobs = [flat[p * m:p * m + hdrs[p][0]].tobytes() for p in range(P)]
    failed = [p for p, h in enumerate(hdrs) if h[4]]
    if abort:
        return blobs  # the caller raises its own error
    if failed:
        p = failed[0]
        _count_error()
        raise CollectiveError(
            f"process {p} failed the statement "
            f"({st.name or 'no program'}) while this one waited at "
            f"{op!r}: {blobs[p].decode(errors='replace')}")
    if any(h[1:4] != hdrs[0][1:4] for h in hdrs):
        _count_error()
        raise CollectiveError(
            f"the processes issued different collectives: process "
            f"{process_index()} is at {op!r}, step {step} of "
            f"{st.name or 'no program'}; (op, program, step) per "
            f"process: {[tuple(h[1:4]) for h in hdrs]}")
    return blobs


def _count_error():
    from ..metrics import REGISTRY

    REGISTRY.inc("dist_collective_errors_total")


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_to_host(v) for v in x)
    return x


def _from_host(x, dev: torch.device):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.array(x, copy=True)).to(dev)
    if isinstance(x, (tuple, list)):
        return type(x)(_from_host(v, dev) for v in x)
    return x


def _first_device(parts) -> torch.device:
    def find(x):
        if isinstance(x, torch.Tensor):
            return x.device
        if isinstance(x, (tuple, list)):
            for v in x:
                d = find(v)
                if d is not None:
                    return d
        return None

    for p in parts:
        d = find(p)
        if d is not None:
            return d
    return torch.device("cpu")


def gather_shards(parts: Sequence) -> list:
    """Every process's per-shard parts: entry s of the result is shard
    s's part (a tensor, or a tuple/list of tensors and ints) from
    whichever process ran it; entries no process ran stay None.  Parts
    of other processes land on the first local tensor's device (the
    host when this process ran none).  One process: the list as it
    is."""
    if not _multi():
        return list(parts)
    from . import process_index

    mine = {s: _to_host(p) for s, p in enumerate(parts) if p is not None}
    blobs = _exchange("gather", pickle.dumps(mine, protocol=5))
    dev = _first_device(parts)
    out = list(parts)
    me = process_index()
    for p, blob in enumerate(blobs):
        if p == me or not blob:
            continue
        for s, v in pickle.loads(blob).items():
            if out[s] is None:
                out[s] = _from_host(v, dev)
    return out


def agree(value, op: str = "agree"):
    """Process 0's value of a host-side decision, on every process (one
    process: `value`).  Decisions that choose which collectives follow
    (the chunk budget, the mesh, a column's tier) must not come from one
    process's own timings or cache state."""
    if not _multi():
        return value
    return pickle.loads(_exchange(op, pickle.dumps(value))[0])


def psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The cross-shard sum: the parts present (not None) added left to
    right in shard order, on the first one's device (float partials add
    in one fixed order).  Across processes, fold the list
    `gather_shards` returned."""
    parts = [x for x in parts if x is not None]
    acc = parts[0]
    for x in parts[1:]:
        acc = acc + x.to(acc.device)
    return acc


def gather0(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The parts present stacked [S', ...] in shard order on the first
    one's device (one readback for a host-side merge, as min/max
    merge)."""
    parts = [x for x in parts if x is not None]
    dev = parts[0].device
    return torch.stack([x.to(dev) for x in parts])


def all_to_all(bucketed: Sequence, owners: Sequence[int]) -> list:
    """The exchange across processes: `bucketed[s]` (local s) is shard
    s's [S, cap, ...] pack whose row d goes to shard d; `owners[s]` is
    the process holding shard s.  Returns entry d (local d) = [S*cap,
    ...] with row block j the partition shard j sent it, on d's device;
    None elsewhere.  Blocks between this process's shards are copies;
    the others travel in ONE all_to_all of equal blocks (the capacities
    are static)."""
    from . import process_index

    dist = _dist()
    S = len(bucketed)
    P = dist.get_world_size()
    me = process_index()
    by_proc = [[s for s in range(S) if owners[s] == q] for q in range(P)]
    local = by_proc[me]
    if not local:
        raise CollectiveError(
            f"process {me} holds no shard of the exchange's mesh")
    blk = bucketed[local[0]][0]
    nb = blk.numel() * blk.element_size()
    # the header first: the block sizes must pair with the same
    # exchange on every process
    _exchange(f"all_to_all {tuple(blk.shape)} {blk.dtype}")
    dev = _comm_device()

    def as_bytes(t):
        return t.contiguous().reshape(-1).view(torch.uint8)

    send = [as_bytes(bucketed[s][d])
            for q in range(P) if q != me
            for s in local for d in by_proc[q]]
    in_splits = [0 if q == me else len(local) * len(by_proc[q]) * nb
                 for q in range(P)]
    out_splits = [0 if q == me else len(by_proc[q]) * len(local) * nb
                  for q in range(P)]
    sendbuf = _staged(torch.cat(send), dev) if send else \
        torch.empty(0, dtype=torch.uint8, device=dev)
    recv = torch.empty(sum(out_splits), dtype=torch.uint8, device=dev)
    with _collective("all_to_all", int(sendbuf.numel())):
        dist.all_to_all_single(recv, sendbuf, out_splits, in_splits)
    base, off = [], 0
    for q in range(P):
        base.append(off)
        off += out_splits[q]
    out: list = [None] * S
    for li, d in enumerate(local):
        ddev = bucketed[d].device
        blocks = []
        for q in range(P):
            for si, s in enumerate(by_proc[q]):
                if q == me:
                    blocks.append(bucketed[s][d].to(ddev))
                    continue
                o = base[q] + (si * len(local) + li) * nb
                blocks.append(recv[o:o + nb].to(ddev).view(blk.dtype)
                              .reshape(blk.shape))
        out[d] = torch.cat(blocks)
    return out
