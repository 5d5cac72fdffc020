"""TPC-H Q1's rows, plain torch over the generated lineitem."""

from __future__ import annotations

from benchmark.refutil import (avg_text, days, dec_text, float_text,
                               group_sums)

FLAGS, STATUS = ["A", "N", "R"], ["F", "O"]


def reference(tables, p, exact=True):
    li = tables["lineitem"]
    qty, price = li["l_quantity"], li["l_extendedprice"]
    disc, tax = li["l_discount"], li["l_tax"]
    g = li["l_returnflag"].long() * 2 + li["l_linestatus"].long()
    g = g.masked_fill(li["l_shipdate"] > days(p["cut"]), 6)
    ones = qty.new_ones(qty.shape)
    if exact:
        dp = price * (100 - disc)                      # scale 4
        sums = group_sums(g, 6, [qty, price, dp, dp * (100 + tax), disc,
                                 ones])
    else:
        q, pr, d = qty.double() / 100, price.double() / 100, disc.double() / 100
        dp = pr * (1 - d)
        sums = group_sums(g, 6, [q, pr, dp, dp * (1 + tax.double() / 100), d,
                                 ones])
    s_qty, s_price, s_dp, s_ch, s_disc, cnt = sums
    rows = []
    for k in range(6):
        c = int(cnt[k])
        if not c:
            continue
        if exact:
            vals = [dec_text(s_qty[k], 2), dec_text(s_price[k], 2),
                    dec_text(s_dp[k], 4), dec_text(s_ch[k], 6),
                    avg_text(s_qty[k], c, 2, 6), avg_text(s_price[k], c, 2, 6),
                    avg_text(s_disc[k], c, 2, 6)]
        else:
            vals = [float_text(s_qty[k]), float_text(s_price[k]),
                    float_text(s_dp[k]), float_text(s_ch[k]),
                    float_text(s_qty[k] / c), float_text(s_price[k] / c),
                    float_text(s_disc[k] / c)]
        rows.append((FLAGS[k // 2], STATUS[k % 2], *vals, str(c)))
    return rows
