"""Expression tree -> torch computation (device eval path).

The device analog of expr/builtins.py: the same trees the host evaluates
with numpy run here as torch ops on the card.  Values flow as
(data, valid) pairs of tensors; dict-encoded string columns arrive as
int32 code tensors (the engine rewrites string constants to codes first
— see torch_engine.rewrite_for_dict).

Every function takes the row count `n` and the device `dev` explicitly,
so constants materialize where the columns live.  Decimal arithmetic is
exact int64: rescales and rounding divide with ``torch.div`` in its
``trunc``/``floor`` modes (the card has an integer divider), with MySQL's
round-half-away-from-zero rule where a decimal narrows.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..expr.expression import ColumnExpr, Constant, Expression, ScalarFunc
from ..types import FieldType, TypeKind, common_compare_type
from ..types.values import parse_date, parse_datetime


class DeviceUnsupported(Exception):
    """Raised when an expression/DAG can't run on the device; callers fall
    back to the CPU engine (the canFuncBePushed miss path)."""


TVal = Tuple[torch.Tensor, torch.Tensor]  # (data, valid)


def _ones(n: int, dev) -> torch.Tensor:
    return torch.ones(n, dtype=torch.bool, device=dev)


def _falses(n: int, dev) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.bool, device=dev)


def _dtype_for(ft: FieldType) -> torch.dtype:
    if ft.kind == TypeKind.JSON or (ft.kind == TypeKind.DECIMAL
                                    and ft.is_wide_decimal):
        # object-dtype host representations never land on the device
        raise DeviceUnsupported(f"{ft.sql_name()} column is host-only")
    if ft.kind == TypeKind.FLOAT:
        return torch.float64
    if ft.kind == TypeKind.DATE:
        return torch.int32
    if ft.kind == TypeKind.STRING:
        return torch.int32  # dictionary codes
    return torch.int64


def _env_device(cols) -> torch.device:
    for k, v in cols.items():
        if k != "__params__":
            return v[0].device
    params = cols.get("__params__")
    if params is not None:
        return params[0].device
    from ..ops import device

    return device()


def compile_expr(e: Expression, cols: Dict[int, TVal], n: int,
                 dev=None) -> TVal:
    """Evaluate `e` over the column environment `cols` (index -> (data,
    valid)); `dev` defaults to where the columns live."""
    if dev is None:
        dev = _env_device(cols)
    if isinstance(e, ColumnExpr):
        if e.index not in cols:
            raise DeviceUnsupported(f"column {e.index} not device-resident")
        return cols[e.index]
    if isinstance(e, Constant):
        slot = getattr(e, "param_slot", None)
        if slot is not None and "__params__" in cols:
            return _param_const(e, slot, cols["__params__"], n, dev)
        return _const(e, n, dev)
    if isinstance(e, ScalarFunc):
        fn = _FUNCS.get(e.name)
        if fn is None:
            raise DeviceUnsupported(
                f"function {e.name} not device-compilable")
        args = [compile_expr(a, cols, n, dev) for a in e.args]
        return fn(e, args, n, dev)
    raise DeviceUnsupported(f"expression {e!r}")


def _param_const(e: Constant, slot, params, n: int, dev) -> TVal:
    """A hoisted constant (serving/params.py ParamConst): its value reads
    from the runtime parameter vectors at EXECUTION time, so
    parameter-different queries of one shape class share one plan.
    Vectors of shape [B, P] / [B, Q] carry a batch of statements (the
    micro-batcher's program): the value is then [B, n], member b's
    parameter broadcast over the rows, and every expression over it
    broadcasts to [B, n] too."""
    which, idx = slot
    pi, pf = params
    src = (pf if which == "f" else pi)[..., idx].to(_dtype_for(e.ftype))
    if src.dim() == 1:
        return src[:, None].expand(-1, n), _ones(n, dev)
    return src.expand(n), _ones(n, dev)


def _const(e: Constant, n: int, dev) -> TVal:
    ft = e.ftype
    if e.value is None:
        return (torch.zeros(n, dtype=_dtype_for(ft), device=dev),
                _falses(n, dev))
    v = e.value
    if ft.kind == TypeKind.STRING:
        if not isinstance(v, (int,)):
            raise DeviceUnsupported("raw string constant on device")
        # dictionary code constant (rewritten)
        return (torch.full((n,), v, dtype=torch.int32, device=dev),
                _ones(n, dev))
    if ft.kind == TypeKind.DATE and isinstance(v, str):
        v = parse_date(v)
    if ft.kind == TypeKind.DATETIME and isinstance(v, str):
        v = parse_datetime(v)
    return (torch.full((n,), v, dtype=_dtype_for(ft), device=dev),
            _ones(n, dev))


def _to_f64(v: TVal, ft: FieldType) -> torch.Tensor:
    d = v[0]
    if ft.kind == TypeKind.DECIMAL:
        return d.to(torch.float64) / (10.0 ** ft.scale)
    return d.to(torch.float64)


def _trunc_div(x: torch.Tensor, p: int) -> torch.Tensor:
    return torch.div(x, p, rounding_mode="trunc")


def _round_div_pow10(d: torch.Tensor, p: int) -> torch.Tensor:
    """round-half-away-from-zero of d / p (p = 10^k): the MySQL decimal
    rounding rule (types/mydecimal.go analog).  Rounds via the remainder
    (not abs(d)+p/2, which overflows at int64 max)."""
    ad = torch.abs(d)
    q = _trunc_div(ad, p)
    rem = ad - q * p
    q = q + (2 * rem >= p).to(torch.int64)
    return torch.sign(d) * q


def _floordiv_const(d: torch.Tensor, p: int) -> torch.Tensor:
    """Python-semantics d // p (floor) for int64 d."""
    return torch.div(d, p, rounding_mode="floor")


def _to_scaled(v: TVal, ft: FieldType, scale: int) -> torch.Tensor:
    d = v[0]
    if ft.kind == TypeKind.DECIMAL:
        ds = scale - ft.scale
        if ds == 0:
            return d.to(torch.int64)
        if ds > 0:
            return d.to(torch.int64) * (10 ** ds)
        return _round_div_pow10(d.to(torch.int64), 10 ** (-ds))
    if ft.kind == TypeKind.FLOAT:
        return torch.round(d * (10.0 ** scale)).to(torch.int64)
    return d.to(torch.int64) * (10 ** scale)


_FUNCS: Dict[str, Callable] = {}


def _reg(*names):
    def deco(fn):
        for nm in names:
            _FUNCS[nm] = fn
        return fn

    return deco


def _both_valid(a: TVal, b: TVal) -> torch.Tensor:
    return a[1] & b[1]


# ---- arithmetic ------------------------------------------------------------


@_reg("+", "-", "*", "/", "div", "%")
def _arith(e: ScalarFunc, args, n, dev):
    op = e.name
    a, b = args
    fa, fb = e.args[0].ftype, e.args[1].ftype
    out = e.ftype
    valid = _both_valid(a, b)
    if out.kind == TypeKind.FLOAT:
        x, y = _to_f64(a, fa), _to_f64(b, fb)
        if op == "+":
            r = x + y
        elif op == "-":
            r = x - y
        elif op == "*":
            r = x * y
        elif op == "/":
            bad = y == 0.0
            r = x / torch.where(bad, 1.0, y)
            valid = valid & ~bad
        elif op == "%":
            bad = y == 0.0
            r = torch.fmod(x, torch.where(bad, 1.0, y))
            valid = valid & ~bad
        else:
            raise DeviceUnsupported("float div")
        return r, valid
    if out.kind == TypeKind.DECIMAL:
        sa = fa.scale if fa.kind == TypeKind.DECIMAL else 0
        sb = fb.scale if fb.kind == TypeKind.DECIMAL else 0
        if op in ("+", "-"):
            s = out.scale
            x, y = _to_scaled(a, fa, s), _to_scaled(b, fb, s)
            return (x + y if op == "+" else x - y), valid
        if op == "*":
            x, y = _to_scaled(a, fa, sa), _to_scaled(b, fb, sb)
            r = x * y
            drop = sa + sb - out.scale
            if drop > 0:
                r = _round_div_pow10(r, 10 ** drop)
            elif drop < 0:
                r = r * (10 ** (-drop))
            return r, valid
        if op == "/":
            x = _to_f64(a, fa)
            y = _to_f64(b, fb)
            bad = y == 0.0
            r = x / torch.where(bad, 1.0, y)
            valid = valid & ~bad
            return torch.round(r * 10.0 ** out.scale).to(torch.int64), valid
        raise DeviceUnsupported(f"decimal {op}")
    # int domain
    x, y = a[0].to(torch.int64), b[0].to(torch.int64)
    if op == "+":
        r = x + y
    elif op == "-":
        r = x - y
    elif op == "*":
        r = x * y
    elif op in ("div", "/"):
        bad = y == 0
        safe = torch.where(bad, 1, y)
        r = torch.div(x, safe, rounding_mode="trunc")
        valid = valid & ~bad
    elif op == "%":
        bad = y == 0
        safe = torch.where(bad, 1, y)
        r = torch.fmod(x, safe)  # sign of the dividend (MySQL %)
        valid = valid & ~bad
    else:
        raise DeviceUnsupported(op)
    return r, valid


@_reg("unaryminus")
def _neg(e, args, n, dev):
    v = args[0]
    if e.ftype.kind == TypeKind.FLOAT:
        return -_to_f64(v, e.args[0].ftype), v[1]
    return -v[0], v[1]


# ---- comparisons -----------------------------------------------------------


@_reg("=", "!=", "<", "<=", ">", ">=")
def _cmp(e, args, n, dev):
    a, b = args
    fa, fb = e.args[0].ftype, e.args[1].ftype
    ct = common_compare_type(fa, fb)
    if ct.kind == TypeKind.STRING:
        # both sides must be dictionary codes (int32) by now
        x, y = a[0].to(torch.int64), b[0].to(torch.int64)
    elif ct.kind == TypeKind.DECIMAL:
        s = max(
            fa.scale if fa.kind == TypeKind.DECIMAL else 0,
            fb.scale if fb.kind == TypeKind.DECIMAL else 0,
        )
        if TypeKind.FLOAT in (fa.kind, fb.kind):
            x, y = _to_f64(a, fa), _to_f64(b, fb)
        else:
            x, y = _to_scaled(a, fa, s), _to_scaled(b, fb, s)
    elif ct.kind == TypeKind.FLOAT:
        x, y = _to_f64(a, fa), _to_f64(b, fb)
    elif ct.kind in (TypeKind.DATE, TypeKind.DATETIME):
        x = _temporal_to(ct.kind, a, fa)
        y = _temporal_to(ct.kind, b, fb)
    else:
        x, y = a[0].to(torch.int64), b[0].to(torch.int64)
    op = e.name
    r = {
        "=": lambda: x == y,
        "!=": lambda: x != y,
        "<": lambda: x < y,
        "<=": lambda: x <= y,
        ">": lambda: x > y,
        ">=": lambda: x >= y,
    }[op]()
    return r.to(torch.int64), _both_valid(a, b)


def _temporal_to(kind, v: TVal, ft: FieldType):
    d = v[0]
    if kind == TypeKind.DATE:
        if ft.kind == TypeKind.DATETIME:
            return _floordiv_const(d.to(torch.int64), 86_400_000_000)
        return d.to(torch.int64)
    if ft.kind == TypeKind.DATE:
        return d.to(torch.int64) * 86_400_000_000
    return d.to(torch.int64)


# ---- logic -----------------------------------------------------------------


def _truth(v: TVal) -> torch.Tensor:
    return v[0] != 0


@_reg("and")
def _and(e, args, n, dev):
    a, b = args
    ta, tb = _truth(a), _truth(b)
    is_false = (a[1] & ~ta) | (b[1] & ~tb)
    valid = is_false | (a[1] & b[1])
    return (~is_false).to(torch.int64), valid


@_reg("or")
def _or(e, args, n, dev):
    a, b = args
    is_true = (a[1] & _truth(a)) | (b[1] & _truth(b))
    valid = is_true | (a[1] & b[1])
    return is_true.to(torch.int64), valid


@_reg("xor")
def _xor(e, args, n, dev):
    a, b = args
    return (_truth(a) ^ _truth(b)).to(torch.int64), _both_valid(a, b)


@_reg("not")
def _not(e, args, n, dev):
    v = args[0]
    return (~_truth(v)).to(torch.int64), v[1]


@_reg("&", "|", "^", "<<", ">>")
def _bitops(e, args, n, dev):
    a, b = args
    x, y = a[0].to(torch.int64), b[0].to(torch.int64)
    op = e.name
    if op == "&":
        r = x & y
    elif op == "|":
        r = x | y
    elif op == "^":
        r = x ^ y
    elif op == "<<":
        sh = torch.clamp(y, 0, 63)
        r = torch.where((y < 0) | (y > 63), 0, x << sh)
    else:
        sh = torch.clamp(y, 0, 63)
        r = torch.where((y < 0) | (y > 63), 0, x >> sh)
    return r, _both_valid(a, b)


@_reg("~")
def _bitneg(e, args, n, dev):
    v = args[0]
    return ~v[0].to(torch.int64), v[1]


@_reg("nulleq")
def _nulleq(e, args, n, dev):
    a, b = args
    sub = ScalarFunc("=", [e.args[0], e.args[1]], e.ftype)
    eq, _ = _cmp(sub, [a, b], n, dev)
    both_null = ~a[1] & ~b[1]
    r = both_null | ((eq != 0) & a[1] & b[1])
    return r.to(torch.int64), _ones(n, dev)


@_reg("isnull")
def _isnull(e, args, n, dev):
    v = args[0]
    return (~v[1]).to(torch.int64), _ones(n, dev)


@_reg("isnotnull")
def _isnotnull(e, args, n, dev):
    v = args[0]
    return v[1].to(torch.int64), _ones(n, dev)


@_reg("istrue")
def _istrue(e, args, n, dev):
    v = args[0]
    return (_truth(v) & v[1]).to(torch.int64), _ones(n, dev)


@_reg("isfalse")
def _isfalse(e, args, n, dev):
    v = args[0]
    return (~_truth(v) & v[1]).to(torch.int64), _ones(n, dev)


@_reg("in")
def _in(e, args, n, dev):
    target = args[0]
    hit = _falses(n, dev)
    any_null_item = _falses(n, dev)
    ft = e.args[0].ftype
    for it_expr, it in zip(e.args[1:], args[1:]):
        sub = ScalarFunc("=", [e.args[0], it_expr],
                         e.ftype)
        eq, _ = _cmp(sub, [target, it], n, dev)
        hit = hit | ((eq != 0) & it[1])
        any_null_item = any_null_item | ~it[1]
    valid = target[1] & (hit | ~any_null_item)
    return hit.to(torch.int64), valid


# ---- control ---------------------------------------------------------------


def _cast_to(v: TVal, src: FieldType, dst: FieldType) -> TVal:
    k, tk = src.kind, dst.kind
    d, valid = v
    if tk == TypeKind.FLOAT:
        return _to_f64(v, src), valid
    if tk == TypeKind.DECIMAL:
        return _to_scaled(v, src, dst.scale), valid
    if tk in (TypeKind.INT, TypeKind.UINT, TypeKind.BOOL):
        if k == TypeKind.FLOAT:
            return torch.round(d).to(torch.int64), valid
        if k == TypeKind.DECIMAL:
            p = 10 ** src.scale
            return _round_div_pow10(d.to(torch.int64), p), valid
        return d.to(torch.int64), valid
    if tk == TypeKind.DATE:
        if k == TypeKind.DATETIME:
            return _floordiv_const(
                d.to(torch.int64), 86_400_000_000
            ).to(torch.int32), valid
        return d.to(torch.int32), valid
    if tk == TypeKind.DATETIME:
        if k == TypeKind.DATE:
            return d.to(torch.int64) * 86_400_000_000, valid
        return d.to(torch.int64), valid
    raise DeviceUnsupported(f"device cast {src} -> {dst}")


@_reg("cast")
def _cast(e, args, n, dev):
    return _cast_to(args[0], e.args[0].ftype, e.ftype)


@_reg("if")
def _if(e, args, n, dev):
    c, a, b = args
    cond = _truth(c) & c[1]
    ta = _cast_to(a, e.args[1].ftype, e.ftype)
    tb = _cast_to(b, e.args[2].ftype, e.ftype)
    return torch.where(cond, ta[0], tb[0]), torch.where(cond, ta[1], tb[1])


@_reg("ifnull")
def _ifnull(e, args, n, dev):
    a, b = args
    ta = _cast_to(a, e.args[0].ftype, e.ftype)
    tb = _cast_to(b, e.args[1].ftype, e.ftype)
    return torch.where(a[1], ta[0], tb[0]), torch.where(a[1], True, tb[1])


@_reg("nullif")
def _nullif(e, args, n, dev):
    a, b = args
    sub = ScalarFunc("=", [e.args[0], e.args[1]], e.ftype)
    eq, _ = _cmp(sub, [a, b], n, dev)
    cond = (eq != 0) & a[1] & b[1]
    ta = _cast_to(a, e.args[0].ftype, e.ftype)
    return ta[0], a[1] & ~cond


@_reg("coalesce")
def _coalesce(e, args, n, dev):
    data, valid = _cast_to(args[0], e.args[0].ftype, e.ftype)
    for i, v in enumerate(args[1:], start=1):
        tv = _cast_to(v, e.args[i].ftype, e.ftype)
        need = ~valid
        data = torch.where(need, tv[0], data)
        valid = valid | (need & tv[1])
    return data, valid


@_reg("case")
def _case(e, args, n, dev):
    has_else = len(args) % 2 == 1
    dt = _dtype_for(e.ftype)
    data = torch.zeros(n, dtype=dt, device=dev)
    valid = _falses(n, dev)
    assigned = _falses(n, dev)
    for i in range(0, len(args) - (1 if has_else else 0), 2):
        cond, val = args[i], args[i + 1]
        m = _truth(cond) & cond[1] & ~assigned
        tv = _cast_to(val, e.args[i + 1].ftype, e.ftype)
        data = torch.where(m, tv[0], data)
        valid = torch.where(m, tv[1], valid)
        assigned = assigned | m
    if has_else:
        m = ~assigned
        tv = _cast_to(args[-1], e.args[-1].ftype, e.ftype)
        data = torch.where(m, tv[0], data)
        valid = torch.where(m, tv[1], valid)
    return data, valid


@_reg("greatest", "least")
def _extremes(e, args, n, dev):
    is_max = e.name == "greatest"
    data, valid = _cast_to(args[0], e.args[0].ftype, e.ftype)
    for i, v in enumerate(args[1:], start=1):
        tv = _cast_to(v, e.args[i].ftype, e.ftype)
        m = tv[0] > data if is_max else tv[0] < data
        data = torch.where(m, tv[0], data)
        valid = valid & tv[1]
    return data, valid


# ---- math ------------------------------------------------------------------


@_reg("abs")
def _abs(e, args, n, dev):
    v = args[0]
    if e.ftype.kind == TypeKind.FLOAT and e.args[0].ftype.kind != TypeKind.FLOAT:
        return torch.abs(_to_f64(v, e.args[0].ftype)), v[1]
    return torch.abs(v[0]), v[1]


@_reg("floor", "ceil", "ceiling")
def _floor_ceil(e, args, n, dev):
    v = args[0]
    ft = e.args[0].ftype
    if ft.kind == TypeKind.DECIMAL:
        s = 10 ** ft.scale
        d = v[0].to(torch.int64)
        r = (_floordiv_const(d, s) if e.name == "floor"
             else -_floordiv_const(-d, s))
        return r, v[1]
    x = _to_f64(v, ft)
    r = torch.floor(x) if e.name == "floor" else torch.ceil(x)
    return r.to(torch.int64), v[1]


@_reg("round")
def _round(e, args, n, dev):
    v = args[0]
    ft = e.args[0].ftype
    d = int(e.args[1].value) if len(e.args) > 1 else 0
    if ft.kind == TypeKind.DECIMAL:
        drop = ft.scale - e.ftype.scale if d >= 0 else ft.scale - d
        x = v[0].to(torch.int64)
        if drop > 0:
            x = _round_div_pow10(x, 10 ** drop)
        if d < 0:
            x = x * (10 ** (-d)) * (10 ** e.ftype.scale)
        return x, v[1]
    if ft.kind == TypeKind.FLOAT:
        x = v[0]
        p = 10.0 ** d
        return torch.sign(x) * torch.floor(torch.abs(x) * p + 0.5) / p, v[1]
    x = v[0].to(torch.int64)
    if d < 0:
        p = 10 ** (-d)
        x = torch.sign(x) * ((torch.abs(x) + p // 2) // p) * p
    return x, v[1]


def _sfloat(name, jf, domain=None):
    @_reg(name)
    def impl(e, args, n, _jf=jf, _domain=domain):
        v = args[0]
        x = _to_f64(v, e.args[0].ftype)
        valid = v[1]
        if _domain is not None:
            ok = _domain(x)
            valid = valid & ok
            x = torch.where(ok, x, 1.0)
        return _jf(x), valid
    return impl


_sfloat("sqrt", torch.sqrt, lambda x: x >= 0)
_sfloat("exp", torch.exp)
_sfloat("ln", torch.log, lambda x: x > 0)
_sfloat("log2", torch.log2, lambda x: x > 0)
_sfloat("log10", torch.log10, lambda x: x > 0)
_sfloat("sin", torch.sin)
_sfloat("cos", torch.cos)
_sfloat("tan", torch.tan)
_sfloat("atan", torch.atan)


@_reg("pow", "power")
def _pow(e, args, n, dev):
    a, b = args
    x = _to_f64(a, e.args[0].ftype)
    y = _to_f64(b, e.args[1].ftype)
    return torch.pow(x, y), _both_valid(a, b)


@_reg("sign")
def _sign(e, args, n, dev):
    v = args[0]
    return torch.sign(_to_f64(v, e.args[0].ftype)).to(torch.int64), v[1]


@_reg("mod")
def _mod(e, args, n, dev):
    e2 = ScalarFunc("%", e.args, e.ftype, e.meta)
    return _arith(e2, args, n, dev)


# ---- temporal --------------------------------------------------------------


def _as_us(v: TVal, ft: FieldType) -> torch.Tensor:
    if ft.kind == TypeKind.DATE:
        return v[0].to(torch.int64) * 86_400_000_000
    return v[0].to(torch.int64)


def _civil(us: torch.Tensor):
    # all divisions are by small constants: the division-free path keeps
    # year()/month()/extract() off XLA's int64-divide emulation
    fd = _floordiv_const
    days = fd(us, 86_400_000_000)
    z = days + 719468
    era = fd(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = fd(doe - fd(doe, 1460) + fd(doe, 36524) - fd(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + fd(yoe, 4) - fd(yoe, 100))
    mp = fd(5 * doy + 2, 153)
    d = doy - fd(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


@_reg("year")
def _year(e, args, n, dev):
    return _civil(_as_us(args[0], e.args[0].ftype))[0], args[0][1]


@_reg("month")
def _month(e, args, n, dev):
    return _civil(_as_us(args[0], e.args[0].ftype))[1], args[0][1]


@_reg("day", "dayofmonth")
def _day(e, args, n, dev):
    return _civil(_as_us(args[0], e.args[0].ftype))[2], args[0][1]


@_reg("quarter")
def _quarter(e, args, n, dev):
    m = _civil(_as_us(args[0], e.args[0].ftype))[1]
    return _floordiv_const(m + 2, 3), args[0][1]


@_reg("dayofweek")
def _dayofweek(e, args, n, dev):
    us = _as_us(args[0], e.args[0].ftype)
    return (_floordiv_const(us, 86_400_000_000) + 4) % 7 + 1, args[0][1]


@_reg("weekday")
def _weekday(e, args, n, dev):
    us = _as_us(args[0], e.args[0].ftype)
    return (_floordiv_const(us, 86_400_000_000) + 3) % 7, args[0][1]


@_reg("unix_timestamp")
def _unix_ts(e, args, n, dev):
    return _floordiv_const(_as_us(args[0], e.args[0].ftype), 1_000_000), args[0][1]


@_reg("date")
def _datefn(e, args, n, dev):
    us = _as_us(args[0], e.args[0].ftype)
    return _floordiv_const(us, 86_400_000_000).to(torch.int32), args[0][1]


@_reg("datediff")
def _datediff(e, args, n, dev):
    a = _floordiv_const(_as_us(args[0], e.args[0].ftype), 86_400_000_000)
    b = _floordiv_const(_as_us(args[1], e.args[1].ftype), 86_400_000_000)
    return a - b, _both_valid(args[0], args[1])


_US_PER = {
    "microsecond": 1,
    "second": 1_000_000,
    "minute": 60_000_000,
    "hour": 3_600_000_000,
    "day": 86_400_000_000,
    "week": 7 * 86_400_000_000,
}


@_reg("date_add", "date_sub")
def _date_addsub(e, args, n, dev):
    unit = e.meta.get("unit", "day")
    if unit not in _US_PER:
        raise DeviceUnsupported(f"device date_{e.name} unit {unit}")
    sign = 1 if e.name == "date_add" else -1
    v, delta = args
    us = _as_us(v, e.args[0].ftype) + sign * delta[0].to(torch.int64) * _US_PER[unit]
    valid = _both_valid(v, delta)
    if e.ftype.kind == TypeKind.DATE:
        return _floordiv_const(us, 86_400_000_000).to(torch.int32), valid
    return us, valid
