"""What the plain references share: wire text of exact decimals and of
doubles, literals back to scaled integers, grouped integer sums.  Plain
torch; nothing of the program under test."""

from __future__ import annotations

import datetime as _dt

import torch

_EPOCH = _dt.date(1970, 1, 1)


def days(iso: str) -> int:
    """'1998-09-02' -> days since 1970-01-01."""
    return (_dt.date.fromisoformat(iso) - _EPOCH).days


def scaled(text: str, scale: int) -> int:
    """A decimal literal as an integer scaled by 10**scale: '0.05', 2 -> 5."""
    whole, _, frac = text.partition(".")
    if len(frac) > scale:
        raise ValueError(f"{text} has more than {scale} decimals")
    return int(whole + frac.ljust(scale, "0"))


def dec_text(iv: int, scale: int) -> str:
    """An exact decimal (integer scaled by 10**scale) as the wire shows
    it: the nearest double's repr while the scaled integer is exact in a
    double (|iv| <= 2**53), past that the exact digits."""
    iv = int(iv)
    if abs(iv) <= 1 << 53:
        return repr(iv / 10**scale)
    sign, a = ("-" if iv < 0 else ""), abs(iv)
    return f"{sign}{a // 10**scale}.{a % 10**scale:0{scale}d}"


def avg_text(total: int, count: int, in_scale: int, out_scale: int) -> str:
    """avg of non-negative decimals at `in_scale` as a decimal at
    `out_scale`, rounded half up."""
    shift = 10 ** (out_scale - in_scale)
    return dec_text((int(total) * shift + int(count) // 2) // int(count),
                    out_scale)


def float_text(x) -> str:
    """A double as the wire shows it (the control's rendering)."""
    return repr(float(x))


def group_sums(groups: torch.Tensor, n: int, values) -> list:
    """Per group 0..n-1, the sum of each tensor in `values` (a row whose
    group is n or more is left out): int64 sums are exact, float64 sums
    are the control's.  One masked sum a group and value, so a handful
    of groups never meet in one atomic add."""
    out = [[0] * n for _ in values]
    for k in range(n):
        m = groups == k
        for j, v in enumerate(values):
            out[j][k] = torch.where(m, v, 0).sum().item()
    return out
