"""TPC-H Q3's rows, plain torch over the generated customer, orders and
lineitem: the segment's customers, their orders before the date looked
up densely by order key (keys lie below 4 x the orders), the lines
shipped after it joined through that lookup, revenue summed per order
exactly at scale 4, the ten largest by revenue, then by order date."""

from __future__ import annotations

import datetime as _dt

import torch

from benchmark.refutil import days, dec_text, float_text

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
LIMIT = 10
_EPOCH = _dt.date(1970, 1, 1)


def reference(tables, p, exact=True):
    cu, od, li = tables["customer"], tables["orders"], tables["lineitem"]
    day = days(p["date"])
    ck, oc = cu["c_custkey"], od["o_custkey"]
    in_segment = torch.zeros(int(max(ck.max(), oc.max())) + 1,
                             dtype=torch.bool, device=ck.device)
    in_segment[ck[cu["c_mktsegment"] == SEGMENTS.index(p["segment"])]] = True
    ok = in_segment[oc] & (od["o_orderdate"] < day)
    okey = od["o_orderkey"]
    size = int(max(okey.max(), li["l_orderkey"].max())) + 1
    order_of = torch.full((size,), -1, dtype=torch.int64, device=okey.device)
    order_of[okey[ok]] = torch.nonzero(ok).reshape(-1)
    at = order_of[li["l_orderkey"]]
    lines = (at >= 0) & (li["l_shipdate"] > day)
    at = at[lines]
    price, disc = li["l_extendedprice"][lines], li["l_discount"][lines]
    if exact:
        rev = price * (100 - disc)                     # scale 4
    else:
        rev = (price.double() / 100) * (1 - disc.double() / 100)
    orders, inv = torch.unique(at, return_inverse=True)
    sums = torch.zeros(orders.shape[0], dtype=rev.dtype,
                       device=rev.device).index_add_(0, inv, rev)
    dates = od["o_orderdate"][orders].long()
    # revenue descending, then order date: two stable sorts
    by_date = torch.argsort(dates, stable=True)
    top = by_date[torch.argsort(sums[by_date], descending=True,
                                stable=True)][:LIMIT]
    rows = []
    for i in top.tolist():
        o = int(orders[i])
        rev_text = (dec_text(int(sums[i]), 4) if exact
                    else float_text(float(sums[i])))
        date = (_EPOCH + _dt.timedelta(days=int(dates[i]))).isoformat()
        rows.append((str(int(okey[o])), rev_text, date,
                     str(int(od["o_shippriority"][o]))))
    return rows
