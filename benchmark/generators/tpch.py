"""TPC-H orders and lineitem, every column, by the rules of the TPC-H
Standard Specification v3.0.1, Clause 4.2.3, drawn whole-column at a
time on the device with a torch.Generator seeded from the run's seed.

- O_ORDERKEY is sparse, as the spec has it: of each 32 keys the first 8
  are used, so SF x 1,500,000 orders span keys 1..SF x 6,000,000.
- Each order has 1..7 lines.  The counts are one fixed multiset whose
  sum is the lineitem table's size (59,986,052 at SF10, the size the
  spec's own generator gives), dealt to the orders in an order drawn
  from the seed: every seed makes tables of the same sizes.
- Derived columns follow the spec: L_SUPPKEY from L_PARTKEY,
  L_EXTENDEDPRICE = L_QUANTITY x P_RETAILPRICE, the ship, commit and
  receipt dates from O_ORDERDATE, L_RETURNFLAG and L_LINESTATUS from
  CURRENTDATE (1995-06-17), O_ORDERSTATUS and O_TOTALPRICE from the
  order's lines.
- Comments are codes into a pool of at most COMMENT_POOL distinct
  texts built from the spec's grammar words (Clause 4.2.2.14), of the
  spec's lengths; the spec's own are nearly all distinct.  The pool
  keeps the codes at a near-unique column's width (more than 2**16
  values).

Decimals are integers scaled by 100, dates days since 1970-01-01,
strings codes into sorted dictionaries.  Nothing of the program under
test is imported."""

from __future__ import annotations

import datetime as _dt
import math

import numpy as np
import torch

_EPOCH = _dt.date(1970, 1, 1)


def _day(iso: str) -> int:
    return (_dt.date.fromisoformat(iso) - _EPOCH).days


STARTDATE, ENDDATE, CURRENTDATE = (_day("1992-01-01"), _day("1998-12-31"),
                                   _day("1995-06-17"))
ORDERS_PER_SF = 1_500_000
#: lineitem rows at SF10 as the spec's generator makes them; other scales
#: keep the same lines per order
LINES_SF10 = 59_986_052
#: distinct texts a comment column draws from
COMMENT_POOL = 1 << 17

COLUMNS = {
    "lineitem": ["l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
                 "l_quantity", "l_extendedprice", "l_discount", "l_tax",
                 "l_returnflag", "l_linestatus", "l_shipdate",
                 "l_commitdate", "l_receiptdate", "l_shipinstruct",
                 "l_shipmode", "l_comment"],
    "orders": ["o_orderkey", "o_custkey", "o_orderstatus", "o_totalprice",
               "o_orderdate", "o_orderpriority", "o_clerk",
               "o_shippriority", "o_comment"],
}
RETURNFLAGS = ["A", "N", "R"]
LINESTATUS = ["F", "O"]
ORDERSTATUS = ["F", "O", "P"]
INSTRUCTIONS = ["COLLECT COD", "DELIVER IN PERSON", "NONE",
                "TAKE BACK RETURN"]
MODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
#: (shortest, longest) text of each comment column
COMMENT_LEN = {"l_comment": (10, 43), "o_comment": (19, 78)}
WORDS = (
    "foxes ideas theodolites pinto beans instructions dependencies excuses "
    "platelets asymptotes courts dolphins multipliers sauternes warthogs "
    "frets dinos attainments somas Tiresias patterns forges braids hockey "
    "players frays warhorses dugouts notornis epitaphs pearls tithes "
    "waters orbits gifts sheaves depths sentiments decoys realms pains "
    "grouches escapades sleep wake are cajole haggle nag use boost affix "
    "detect integrate maintain nod was lose sublate solve thrash promise "
    "engage hinder print x-ray breach eat grow impress mold poach serve "
    "run dazzle snooze doze unwind kindle play hang believe doubt furious "
    "sly careful blithe quick fluffy slow quiet ruthless thin close dogged "
    "daring brave stealthy permanent enticing idle busy regular final "
    "ironic even bold silent sometimes always never furiously slyly "
    "carefully blithely quickly fluffily slowly quietly ruthlessly thinly "
    "closely doggedly daringly bravely stealthily permanently enticingly "
    "idly busily regularly finally ironically evenly boldly silently about "
    "above according to across after against along among around at atop "
    "before behind beneath beside besides between beyond by despite "
    "during except for from inside instead of into near on outside over "
    "past since through throughout toward under until up upon without "
    "with within do may might shall will would can could should ought to "
    "must will have to shall have to could have to should have to must "
    "have to need to try to").split()


def sizes(scale: float) -> dict:
    """Rows of each table at scale factor `scale`."""
    n_orders = round(ORDERS_PER_SF * scale)
    return {"orders": n_orders,
            "lineitem": round(n_orders * LINES_SF10 / (10 * ORDERS_PER_SF))}


def domain(column: str, scale: float) -> int:
    """How many values lie in the range `generate` draws `column` from
    at scale factor `scale` (its packed width is the log2 of this)."""
    parts = round(200_000 * scale)
    ship_lo, ship_hi = STARTDATE + 1, ENDDATE - 151 + 121
    return {
        "l_orderkey": 4 * round(ORDERS_PER_SF * scale),
        "l_partkey": parts,
        "l_suppkey": round(10_000 * scale),
        "l_linenumber": 7,
        "l_quantity": 50 * 100 - 100 + 1,
        "l_extendedprice": 50 * _retail_max(parts) - 90_000 + 1,
        "l_discount": 11, "l_tax": 9,
        "l_returnflag": len(RETURNFLAGS), "l_linestatus": len(LINESTATUS),
        "l_shipdate": ship_hi - ship_lo + 1,
        "l_commitdate": (ENDDATE - 151 + 90) - (STARTDATE + 30) + 1,
        "l_receiptdate": ship_hi + 30 - ship_lo,
        "l_shipinstruct": len(INSTRUCTIONS), "l_shipmode": len(MODES),
        "l_comment": COMMENT_POOL,
        "o_orderkey": 4 * round(ORDERS_PER_SF * scale),
        "o_custkey": round(150_000 * scale),
        "o_orderstatus": len(ORDERSTATUS),
        "o_totalprice": 7 * _totalprice_line_max(parts) + 1,
        "o_orderdate": ENDDATE - 151 - STARTDATE + 1,
        "o_orderpriority": len(PRIORITIES),
        "o_clerk": max(round(1_000 * scale), 1),
        "o_shippriority": 1,
        "o_comment": COMMENT_POOL,
    }[column]


def _retail_cents(partkey):
    """P_RETAILPRICE in cents: 90000 + ((P/10) mod 20001) + 100 (P mod 1000)."""
    return 90_000 + (partkey // 10) % 20_001 + 100 * (partkey % 1_000)


def _retail_max(parts: int) -> int:
    return int(_retail_cents(np.arange(1, parts + 1)).max())


def _totalprice_line_max(parts: int) -> int:
    """The largest line's share of O_TOTALPRICE, in cents."""
    return math.ceil(50 * _retail_max(parts) * 108 * 100 / 10_000)


def _line_counts(n_orders: int, n_lines: int) -> np.ndarray:
    """One fixed multiset of lines per order (1..7) summing to `n_lines`,
    the same whatever the seed."""
    counts = np.random.default_rng(0x7C9B).integers(1, 8, n_orders,
                                                    dtype=np.int64)
    diff = n_lines - int(counts.sum())
    room = np.flatnonzero(counts < 7 if diff > 0 else counts > 1)
    if abs(diff) > len(room):
        raise ValueError(f"{n_lines} lines do not fit {n_orders} orders")
    counts[room[:abs(diff)]] += 1 if diff > 0 else -1
    return counts


def _comment_pool(seed: int, column: str) -> list:
    """A sorted pool of distinct texts of the column's lengths."""
    rng = np.random.default_rng([seed, len(column)])
    lo, hi = COMMENT_LEN[column]
    words = np.array(WORDS, dtype=object)
    picks = words[rng.integers(0, len(WORDS), (COMMENT_POOL, hi // 3 + 2))]
    cut = rng.integers(lo, hi + 1, COMMENT_POOL).tolist()
    return sorted({" ".join(p)[:c].rstrip()
                   for p, c in zip(picks.tolist(), cut)})


def generate(scale: float, seed: int, tables, device="cpu") -> dict:
    """{table: (column arrays in COLUMNS order, {column index: sorted
    dictionary})} for each of `tables` ("lineitem", "orders") at scale
    factor `scale`, from `seed` (0..2**64-1).  The columns are drawn on
    `device` and handed back as numpy arrays."""
    n = sizes(scale)
    n_orders, n_lines = n["orders"], n["lineitem"]
    sf_parts, sf_supps = round(200_000 * scale), round(10_000 * scale)
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def draw(lo, hi, size, dtype=torch.int32):
        """Uniform whole numbers in lo..hi."""
        return torch.randint(lo, hi + 1, (size,), generator=g,
                             device=device, dtype=dtype)

    i = torch.arange(n_orders, device=device)
    o_orderkey = (i >> 3) * 32 + (i & 7) + 1
    o_orderdate = STARTDATE + draw(0, ENDDATE - 151 - STARTDATE, n_orders)
    counts = torch.from_numpy(_line_counts(n_orders, n_lines)).to(device)
    counts = counts[torch.randperm(n_orders, generator=g, device=device)]
    starts = torch.cumsum(counts, 0) - counts
    of_line = torch.repeat_interleave(i, counts)

    partkey = draw(1, sf_parts, n_lines, torch.int64)
    j = draw(0, 3, n_lines, torch.int64)
    suppkey = (partkey + j * (sf_supps // 4 + (partkey - 1) // sf_supps)
               ) % sf_supps + 1
    qty = draw(1, 50, n_lines, torch.int64)
    price = qty * _retail_cents(partkey)
    disc = draw(0, 10, n_lines, torch.int64)
    tax = draw(0, 8, n_lines, torch.int64)
    odate = o_orderdate[of_line]
    ship = odate + draw(1, 121, n_lines)
    commit = odate + draw(30, 90, n_lines)
    receipt = ship + draw(1, 30, n_lines)
    flag = torch.where(receipt <= CURRENTDATE, 2 * draw(0, 1, n_lines),
                       torch.ones_like(receipt))
    status = (ship > CURRENTDATE).to(torch.int32)
    out = {}
    if "lineitem" in tables:
        pool = _comment_pool(seed, "l_comment")
        cols = [o_orderkey[of_line], partkey, suppkey,
                torch.arange(n_lines, device=device)
                - starts[of_line] + 1,
                qty * 100, price, disc, tax, flag, status, ship, commit,
                receipt, draw(0, len(INSTRUCTIONS) - 1, n_lines),
                draw(0, len(MODES) - 1, n_lines),
                draw(0, len(pool) - 1, n_lines)]
        out["lineitem"] = ([c.cpu().numpy() for c in cols],
                           {8: RETURNFLAGS, 9: LINESTATUS, 13: INSTRUCTIONS,
                            14: MODES, 15: pool})
    if "orders" in tables:
        n_open = torch.zeros_like(counts).index_add_(0, of_line, status.long())
        charge = torch.zeros_like(counts).index_add_(
            0, of_line, price * (100 + tax) * (100 - disc))   # scale 6
        cust = draw(0, round(100_000 * scale) - 1, n_orders, torch.int64)
        clerks = max(round(1_000 * scale), 1)
        pool = _comment_pool(seed, "o_comment")
        cols = [o_orderkey,
                3 * (cust // 2) + 1 + cust % 2,      # never a multiple of 3
                torch.where(n_open == 0, 0,
                            torch.where(n_open == counts, 1, 2)).int(),
                (charge + 5_000) // 10_000,
                o_orderdate,
                draw(0, len(PRIORITIES) - 1, n_orders),
                draw(0, clerks - 1, n_orders),
                torch.zeros(n_orders, dtype=torch.int64, device=device),
                draw(0, len(pool) - 1, n_orders)]
        out["orders"] = ([c.cpu().numpy() for c in cols],
                         {2: ORDERSTATUS, 5: PRIORITIES,
                          6: [f"Clerk#{k:09d}" for k in range(1, clerks + 1)],
                          8: pool})
    return out
