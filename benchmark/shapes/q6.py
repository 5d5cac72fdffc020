"""TPC-H Q6's row, plain torch over the generated lineitem."""

from __future__ import annotations

from benchmark.refutil import days, dec_text, float_text, scaled


def reference(tables, p, exact=True):
    li = tables["lineitem"]
    ship, disc = li["l_shipdate"], li["l_discount"]
    m = ((ship >= days(p["date_lo"])) & (ship < days(p["date_hi"]))
         & (disc >= scaled(p["disc_lo"], 2)) & (disc <= scaled(p["disc_hi"], 2))
         & (li["l_quantity"] < scaled(str(p["quantity"]), 2)))
    if not bool(m.any()):
        return [(None,)]
    price = li["l_extendedprice"][m]
    if exact:
        return [(dec_text((price * disc[m]).sum().item(), 4),)]
    return [(float_text(((price.double() / 100)
                         * (disc[m].double() / 100)).sum().item()),)]
