"""TPC-H customer, orders and lineitem, every column, by the rules of the
TPC-H Standard Specification v3.0.1, Clause 4.2.3: the three tables
query Q3 joins.

Orders and lineitem come from `benchmark.generators.tpch.generate`,
unchanged.  Customer is drawn here, whole-column at a time on the
device with a torch.Generator of its own:

- C_CUSTKEY 1..SF x 150,000, one row each, in key order; O_CUSTKEY
  (from `tpch`) lies in that range and skips multiples of 3, as the
  spec has it, so a third of the customers place no order;
- C_NAME "Customer#" and the key in 9 digits;
- C_NATIONKEY uniform in 0..24, C_PHONE from it (Clause 4.2.2.9: the
  country code NATIONKEY + 10, then 3, 3 and 4 random digits);
- C_ACCTBAL uniform in -999.99..9,999.99;
- C_MKTSEGMENT uniform over the spec's five segments;
- C_ADDRESS and C_COMMENT codes into pools of at most COMMENT_POOL
  distinct texts of the spec's lengths (10-40 and 29-116 characters),
  built from the spec's grammar words, as `tpch` does for its comments.

Decimals are integers scaled by 100, strings codes into sorted
dictionaries.  Nothing of the program under test is imported."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.generators import tpch

CUSTOMERS_PER_SF = 150_000
COMMENT_POOL = tpch.COMMENT_POOL
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
NATIONS = 25
#: (shortest, longest) text of each pooled customer column
TEXT_LEN = {"c_address": (10, 40), "c_comment": (29, 116)}
#: account balance in cents, the spec's -999.99..9,999.99
ACCTBAL = (-99_999, 999_999)

COLUMNS = {
    **tpch.COLUMNS,
    "customer": ["c_custkey", "c_name", "c_address", "c_nationkey",
                 "c_phone", "c_acctbal", "c_mktsegment", "c_comment"],
}


def sizes(scale: float) -> dict:
    """Rows of each table at scale factor `scale`."""
    return {**tpch.sizes(scale),
            "customer": round(CUSTOMERS_PER_SF * scale)}


def domain(column: str, scale: float) -> int:
    """How many values lie in the range `generate` draws `column` from
    at scale factor `scale` (its packed width is the log2 of this)."""
    n_cust = round(CUSTOMERS_PER_SF * scale)
    own = {
        "c_custkey": n_cust, "c_name": n_cust,
        "c_address": COMMENT_POOL, "c_nationkey": NATIONS,
        "c_phone": n_cust, "c_acctbal": ACCTBAL[1] - ACCTBAL[0] + 1,
        "c_mktsegment": len(SEGMENTS), "c_comment": COMMENT_POOL,
    }
    return own[column] if column in own else tpch.domain(column, scale)


def _text_pool(seed: int, column: str) -> list:
    """A sorted pool of distinct texts of the column's lengths."""
    rng = np.random.default_rng([seed, len(column), 3])
    lo, hi = TEXT_LEN[column]
    words = np.array(tpch.WORDS, dtype=object)
    picks = words[rng.integers(0, len(tpch.WORDS),
                               (COMMENT_POOL, hi // 3 + 2))]
    cut = rng.integers(lo, hi + 1, COMMENT_POOL).tolist()
    return sorted({" ".join(p)[:c].rstrip()
                   for p, c in zip(picks.tolist(), cut)})


def _phones(nation: np.ndarray, local: np.ndarray) -> tuple:
    """(codes, sorted dictionary) of 'CC-ddd-ddd-dddd' texts: country
    code NATIONKEY + 10, then the three local groups.  Every part has a
    fixed width, so the texts sort as the numbers their digits spell."""
    a, b, c = local.T.astype(np.int64)
    spelled = ((nation.astype(np.int64) + 10) * 10**10 + a * 10**7
               + b * 10**4 + c)
    uniq, codes = np.unique(spelled, return_inverse=True)
    text = [f"{v // 10**10}-{v // 10**7 % 1000}-{v // 10**4 % 1000}-"
            f"{v % 10**4}" for v in uniq.tolist()]
    return codes.astype(np.int32), text


def _customer(scale: float, seed: int, device) -> tuple:
    n = round(CUSTOMERS_PER_SF * scale)
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, 3])
                      .generate_state(1, np.uint64)[0]))

    def draw(lo, hi, dtype=torch.int32):
        return torch.randint(lo, hi + 1, (n,), generator=g, device=device,
                             dtype=dtype)

    address, comment = (_text_pool(seed, c) for c in ("c_address",
                                                      "c_comment"))
    nation = draw(0, NATIONS - 1)
    local = torch.stack([draw(100, 999), draw(100, 999), draw(1000, 9999)],
                        1)
    acct = draw(*ACCTBAL, dtype=torch.int64)
    segment = draw(0, len(SEGMENTS) - 1)
    addr_codes = draw(0, len(address) - 1)
    comment_codes = draw(0, len(comment) - 1)
    nation_np = nation.cpu().numpy()
    phone_codes, phones = _phones(nation_np, local.cpu().numpy())
    cols = [np.arange(1, n + 1, dtype=np.int64),
            np.arange(n, dtype=np.int32),
            addr_codes.cpu().numpy(), nation_np.astype(np.int64),
            phone_codes, acct.cpu().numpy(), segment.cpu().numpy(),
            comment_codes.cpu().numpy()]
    names = [f"Customer#{k:09d}" for k in range(1, n + 1)]
    return cols, {1: names, 2: address, 4: phones, 6: SEGMENTS,
                  7: comment}


def generate(scale: float, seed: int, tables, device="cpu") -> dict:
    """{table: (column arrays in COLUMNS order, {column index: sorted
    dictionary})} for each of `tables` ("customer", "orders",
    "lineitem") at scale factor `scale`, from `seed` (0..2**64-1).
    Orders and lineitem are `tpch.generate`'s for the same seed."""
    out = tpch.generate(scale, seed,
                        [t for t in tables if t != "customer"], device)
    if "customer" in tables:
        out["customer"] = _customer(scale, seed, device)
    return out
