"""Aggregate partial-state kernels (host/numpy side).

Shared by: the CPU cop engine (producing partials), the root HashAgg
(merging partials / final agg), and tests as the oracle for the jax engine.
Reference pattern: executor/aggfuncs PartialResult + AggFuncToPBExpr
partial/final split.

All functions are vectorized over a group-index array ``gidx`` (values in
[0, G)); states are lists of numpy arrays of length G.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..chunk import Chunk, Column
from ..errors import ExecutorError
from ..expr.aggregation import AggDesc, avg_type, sum_type
from ..expr.vec import Vec
from ..types import FieldType, TypeKind
from ..types.values import decimal_round_half_up


def _sum_repr(v: Vec, st: FieldType) -> np.ndarray:
    """Arg values in the sum-state representation (scaled int64 / float64)."""
    from ..expr.builtins import cast_vec

    return cast_vec(v, st).data


def group_indices(cols: List[Column]) -> Tuple[np.ndarray, np.ndarray, int]:
    """Map rows to dense group ids.  Returns (gidx, first, G): `first[g]`
    is the row where group g first appears (`key_columns` reads the keys
    there).

    Single fixed-width columns factorize through the native open-addressing
    hash (tidb_tpu/native), assigning codes in first-appearance order — the
    C-speed replacement for the reference's row-at-a-time agg hash maps."""
    n = len(cols[0]) if cols else 0
    if not cols:
        return np.zeros(n, dtype=np.int64), np.zeros(1, dtype=np.int64), 1
    if len(cols) == 1 and cols[0].data.dtype != object and n:
        from ..native import KeyTable

        c = cols[0]
        data = c.data
        if data.dtype == np.float64:
            data = np.where(data == 0.0, 0.0, data).view(np.int64)
        else:
            data = data.astype(np.int64, copy=False)
        valid = c.valid  # None = all valid
        kt = KeyTable(min(n, 1 << 20))
        gidx = kt.upsert(data, valid)
        n_named = int(gidx.max()) + 1 if (gidx >= 0).any() else 0
        has_null = bool((gidx < 0).any())
        if has_null:
            gidx = np.where(gidx < 0, n_named, gidx)  # NULL = its own group
        G = n_named + (1 if has_null else 0)
        # first-occurrence row per group
        first = np.full(G, n, dtype=np.int64)
        np.minimum.at(first, gidx, np.arange(n, dtype=np.int64))
        return gidx, first, G
    # multi-column / object keys: per-column vectorized factorize +
    # mixed-radix combine (re-factorized per step so codes stay < n and
    # never overflow), then a first-appearance remap so group ids and
    # key ordering match the old row-at-a-time dict exactly.  NULL is
    # its own code per column (validity joins the key), and equal float
    # keys collapse like the single-column bit-domain path.
    if n == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64), 0
    combined = np.zeros(n, dtype=np.int64)
    for c in cols:
        inv, card = _factorize_column(c)
        combined = combined * card + inv
        combined = np.unique(combined, return_inverse=True)[1] \
            .astype(np.int64)
    G = int(combined.max()) + 1
    first = np.full(G, n, dtype=np.int64)
    np.minimum.at(first, combined, np.arange(n, dtype=np.int64))
    order = np.argsort(first, kind="stable")
    rank = np.empty(G, dtype=np.int64)
    rank[order] = np.arange(G, dtype=np.int64)
    gidx = rank[combined]
    return gidx, first[order], G


def key_columns(cols: List[Column], first: np.ndarray) -> List[Column]:
    """Each key column's value at its groups' first rows, one row a
    group, as `Column.from_values` builds them (NULL data zeroed, or the
    object fill)."""
    out = []
    for c in cols:
        dt = c.ftype.np_dtype
        data = c.data[first]
        if dt != object:
            data = data.astype(dt)
        valid = None if c.valid is None else c.valid[first]
        if valid is not None and not valid.all():
            data[~valid] = Column._object_fill(c.ftype) if dt == object else 0
        out.append(Column(c.ftype, data, valid))
    return out


def _factorize_column(c: Column) -> Tuple[np.ndarray, int]:
    """(dense codes, cardinality) for one key column, NULL rows coded 0.
    np.unique vectorizes str/numeric payloads; exotic object payloads
    (mixed types that don't compare) fall back to a hash-map pass."""
    n = len(c)
    data, valid = c.data, c.valid
    try:
        if valid is None:
            _u, iv = np.unique(data, return_inverse=True)
            return iv.astype(np.int64, copy=False), max(len(_u), 1)
        inv = np.zeros(n, dtype=np.int64)
        _u, iv = np.unique(data[valid], return_inverse=True)
        inv[valid] = iv.astype(np.int64, copy=False) + 1
        return inv, len(_u) + 1
    except TypeError:
        codes: Dict[object, int] = {}
        inv = np.zeros(n, dtype=np.int64)
        vv = valid
        for i, x in enumerate(data.tolist()):
            if vv is not None and not vv[i]:
                continue  # NULL keeps code 0
            g = codes.get(x)
            if g is None:
                g = codes[x] = len(codes) + 1
            inv[i] = g
        return inv, len(codes) + 1


def partial_states(agg: AggDesc, arg_vecs: List[Vec], gidx: np.ndarray,
                   G: int) -> List[Column]:
    """Compute per-group partial state columns from raw rows."""
    name = agg.name
    pts = agg.partial_types()
    if name == "count":
        if not agg.args or isinstance(arg_vecs[0], type(None)):
            cnt = np.bincount(gidx, minlength=G).astype(np.int64)
        else:
            v = arg_vecs[0]
            cnt = np.bincount(gidx, weights=v.validity().astype(np.float64),
                              minlength=G).astype(np.int64)
        return [Column(pts[0], cnt)]
    v = arg_vecs[0]
    valid = v.validity()
    if name in ("sum", "avg"):
        st = pts[0]
        data = _sum_repr(v, st)
        acc = np.zeros(G, dtype=st.np_dtype)
        masked = np.where(valid, data, 0)
        np.add.at(acc, gidx, masked)
        cnt = np.bincount(gidx, weights=valid.astype(np.float64),
                          minlength=G).astype(np.int64)
        sum_col = Column(st, acc, (cnt > 0))
        if name == "sum":
            return [sum_col]
        return [sum_col, Column(pts[1], cnt)]
    if name in ("min", "max"):
        st = pts[0]
        if st.np_dtype == object:
            # strings and wide decimals (Python ints past int64) have no
            # fixed-width identity: each group starts from its first
            # valid row
            vi = np.flatnonzero(valid)
            gv = gidx[vi]
            first = np.full(G, -1, dtype=np.int64)
            first[gv[::-1]] = vi[::-1]
            ovalid = first >= 0
            data = np.empty(G, dtype=object)
            data[:] = "" if st.kind == TypeKind.STRING else 0
            data[ovalid] = v.data[first[ovalid]]
            op = np.minimum if name == "min" else np.maximum
            op.at(data, gv, v.data[vi])
            return [Column(st, data, ovalid)]
        if st.np_dtype == np.float64:
            ident = np.inf if name == "min" else -np.inf
        else:
            # the identity of the state's own width: an int64 extreme
            # cast into an int32 (DATE) state would wrap to -1 / 0
            info = np.iinfo(st.np_dtype)
            ident = info.max if name == "min" else info.min
        acc = np.full(G, ident, dtype=st.np_dtype)
        masked = np.where(valid, v.data, ident)
        if name == "min":
            np.minimum.at(acc, gidx, masked)
        else:
            np.maximum.at(acc, gidx, masked)
        cnt = np.bincount(gidx, weights=valid.astype(np.float64), minlength=G)
        ovalid = cnt > 0
        acc = np.where(ovalid, acc, 0)
        return [Column(st, acc.astype(st.np_dtype), ovalid)]
    if name == "first_row":
        st = pts[0]
        seen = np.zeros(G, dtype=np.bool_)
        if st.kind == TypeKind.STRING:
            data = np.empty(G, dtype=object)
            data[:] = ""
        else:
            data = np.zeros(G, dtype=st.np_dtype)
        ovalid = np.zeros(G, dtype=np.bool_)
        for i in range(len(gidx)):
            g = gidx[i]
            if not seen[g]:
                seen[g] = True
                data[g] = v.data[i]
                ovalid[g] = valid[i]
        return [Column(st, data, ovalid)]
    if name in ("bit_and", "bit_or", "bit_xor"):
        ident = -1 if name == "bit_and" else 0
        acc = np.full(G, ident, dtype=np.int64)
        masked = np.where(valid, v.data.astype(np.int64), ident)
        op = {"bit_and": np.bitwise_and, "bit_or": np.bitwise_or,
              "bit_xor": np.bitwise_xor}[name]
        op.at(acc, gidx, masked)
        return [Column(pts[0], acc)]
    if name in ("var_pop", "stddev_pop", "var_samp", "stddev_samp"):
        from ..expr.builtins import _to_float

        x = np.where(valid, _to_float(v), 0.0)
        s = np.zeros(G)
        np.add.at(s, gidx, x)
        s2 = np.zeros(G)
        np.add.at(s2, gidx, x * x)
        cnt = np.bincount(gidx, weights=valid.astype(np.float64),
                          minlength=G).astype(np.int64)
        return [Column(pts[0], s), Column(pts[1], s2), Column(pts[2], cnt)]
    if name == "group_concat":
        from ..expr.builtins import _str_data

        sep = agg.ftype and ","  # MySQL default separator
        strs = _str_data(v)
        parts: List[List[str]] = [[] for _ in range(G)]
        for i in range(len(gidx)):
            if valid[i]:
                parts[gidx[i]].append(str(strs[i]))
        out = np.empty(G, dtype=object)
        ovalid = np.zeros(G, dtype=np.bool_)
        for g in range(G):
            if parts[g]:
                out[g] = ",".join(parts[g])
                ovalid[g] = True
            else:
                out[g] = ""
        return [Column(pts[0], out, ovalid)]
    raise ExecutorError(f"partial_states: unsupported agg {name}")


def merge_states(agg: AggDesc, state_cols: List[Column], gidx: np.ndarray,
                 G: int) -> List[Column]:
    """Merge partial-state rows into G groups (final-merge accumulation)."""
    name = agg.name
    pts = agg.partial_types()
    if name == "count":
        acc = np.zeros(G, dtype=np.int64)
        np.add.at(acc, gidx, state_cols[0].data)
        return [Column(pts[0], acc)]
    if name in ("sum", "avg"):
        st = pts[0]
        acc = np.zeros(G, dtype=st.np_dtype)
        sv = state_cols[0]
        np.add.at(acc, gidx, np.where(sv.validity(), sv.data, 0))
        if name == "sum":
            cnt = np.zeros(G, dtype=np.int64)
            np.add.at(cnt, gidx, sv.validity().astype(np.int64))
            return [Column(st, acc, cnt > 0)]
        cnt = np.zeros(G, dtype=np.int64)
        np.add.at(cnt, gidx, state_cols[1].data)
        return [Column(st, acc, cnt > 0), Column(pts[1], cnt)]
    if name in ("min", "max", "first_row"):
        # reuse row-accumulation on the state column
        sub = AggDesc(name, agg.args, agg.distinct, agg.ftype)
        return partial_states(sub, [Vec.from_column(state_cols[0])], gidx, G)
    if name in ("bit_and", "bit_or", "bit_xor"):
        ident = -1 if name == "bit_and" else 0
        acc = np.full(G, ident, dtype=np.int64)
        op = {"bit_and": np.bitwise_and, "bit_or": np.bitwise_or,
              "bit_xor": np.bitwise_xor}[name]
        op.at(acc, gidx, state_cols[0].data)
        return [Column(pts[0], acc)]
    if name in ("var_pop", "stddev_pop", "var_samp", "stddev_samp"):
        s = np.zeros(G)
        np.add.at(s, gidx, state_cols[0].data)
        s2 = np.zeros(G)
        np.add.at(s2, gidx, state_cols[1].data)
        cnt = np.zeros(G, dtype=np.int64)
        np.add.at(cnt, gidx, state_cols[2].data)
        return [Column(pts[0], s), Column(pts[1], s2), Column(pts[2], cnt)]
    if name == "group_concat":
        parts: List[List[str]] = [[] for _ in range(G)]
        sv = state_cols[0]
        valid = sv.validity()
        for i in range(len(gidx)):
            if valid[i]:
                parts[gidx[i]].append(str(sv.data[i]))
        out = np.empty(G, dtype=object)
        ovalid = np.zeros(G, dtype=np.bool_)
        for g in range(G):
            if parts[g]:
                out[g] = ",".join(parts[g])
                ovalid[g] = True
            else:
                out[g] = ""
        return [Column(pts[0], out, ovalid)]
    raise ExecutorError(f"merge_states: unsupported agg {name}")


def merge_partials_to_final(n_keys: int, aggs: List[AggDesc],
                            chunks: List[Chunk]) -> Optional[Chunk]:
    """Merge partial-state chunks ([keys..., states...] layout) from many
    shards/engines into one final chunk [keys..., finals...].

    Returns None when there are no input rows AND n_keys > 0 (empty group-by
    result); for scalar agg (n_keys == 0) the caller handles the
    one-row-from-nothing case."""
    rows = [c for c in chunks if c is not None and c.num_rows > 0]
    if not rows:
        return None
    whole = rows[0]
    for c in rows[1:]:
        whole = whole.append(c)
    key_cols = [whole.col(i) for i in range(n_keys)]
    if key_cols:
        gidx, first, G = group_indices(key_cols)
    else:
        gidx, first, G = np.zeros(whole.num_rows, dtype=np.int64), None, 1
    out_cols: List[Column] = (key_columns(key_cols, first) if key_cols
                              else [])
    off = n_keys
    for a in aggs:
        width = len(a.partial_types())
        states = [whole.col(off + j) for j in range(width)]
        off += width
        merged = merge_states(a, states, gidx, G)
        out_cols.append(finalize(a, merged))
    return Chunk(out_cols)


def empty_final_row(aggs: List[AggDesc]) -> Chunk:
    """The one row a scalar aggregation yields over zero input rows:
    COUNT -> 0, SUM/AVG/MIN/MAX -> NULL."""
    cols = []
    for a in aggs:
        if a.name == "count":
            cols.append(Column(a.ftype, np.zeros(1, dtype=np.int64)))
        elif a.name in ("bit_or", "bit_xor"):
            cols.append(Column(a.ftype, np.zeros(1, dtype=np.int64)))
        elif a.name == "bit_and":
            cols.append(Column(a.ftype, np.full(1, -1, dtype=np.int64)))
        else:
            cols.append(Column.nulls(a.ftype, 1))
    return Chunk(cols)


def finalize(agg: AggDesc, states: List[Column]) -> Column:
    """Final value from merged states."""
    name = agg.name
    ft = agg.ftype
    if name == "count":
        return Column(ft, states[0].data.astype(np.int64))
    if name == "sum":
        s = states[0]
        return Column(ft, s.data.astype(ft.np_dtype) if ft.np_dtype != s.data.dtype
                      else s.data, s.valid)
    if name == "avg":
        s, c = states
        cnt = c.data
        safe = np.where(cnt > 0, cnt, 1)
        if ft.kind == TypeKind.FLOAT:
            data = s.data.astype(np.float64) / safe
        else:
            # decimal: state scale -> result scale with round-half-up
            st = sum_type(agg.args[0].ftype)
            up = ft.scale - st.scale
            num = s.data.astype(np.int64) * (10 ** max(up, 0))
            sign = np.sign(num)
            data = sign * ((np.abs(num) + safe // 2) // safe)
        return Column(ft, data.astype(ft.np_dtype), (cnt > 0))
    if name in ("min", "max", "first_row"):
        s = states[0]
        return Column(ft, s.data, s.valid)
    if name in ("bit_and", "bit_or", "bit_xor"):
        return Column(ft, states[0].data)
    if name in ("var_pop", "stddev_pop", "var_samp", "stddev_samp"):
        s, s2, c = (x.data for x in states)
        cnt = np.where(c > 0, c, 1).astype(np.float64)
        mean = s / cnt
        var = s2 / cnt - mean * mean
        var = np.maximum(var, 0.0)
        if name in ("var_samp", "stddev_samp"):
            denom = np.where(c > 1, c - 1, 1).astype(np.float64)
            var = var * cnt / denom
            valid = c > 1
        else:
            valid = c > 0
        data = np.sqrt(var) if name.startswith("stddev") else var
        return Column(ft, data, valid)
    if name == "group_concat":
        s = states[0]
        return Column(ft, s.data, s.valid)
    raise ExecutorError(f"finalize: unsupported agg {name}")
