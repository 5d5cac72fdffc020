"""Shared TPC-H-shaped data generation.

One lineitem recipe (the JAX package's, draw for draw) so both packages,
the tests and the chip smoke run can never drift apart on schema or data
distribution.
"""

from __future__ import annotations

import numpy as np

# authentic TPC-H column types (the reference's lineitem DDL uses
# DECIMAL(15,2) for quantity/extendedprice/discount/tax): decimals store
# as scaled int64, so every money column narrows on the wire
# (store/blockstore.py scaled-int decimal + parallel._wire_dtype)
LINEITEM_DDL = (
    "create table lineitem ("
    " l_orderkey bigint, l_quantity decimal(15,2),"
    " l_extendedprice decimal(15,2), l_discount decimal(15,2),"
    " l_tax decimal(15,2),"
    " l_returnflag varchar(1), l_linestatus varchar(1),"
    " l_shipdate date)"
)


#: TPC-H Q1 and Q6 over the `build_lineitem` table (the texts bench.py
#: drives against the JAX package)
LINEITEM_Q1 = """
select l_returnflag, l_linestatus,
       sum(l_quantity), sum(l_extendedprice),
       sum(l_extendedprice * (1 - l_discount)),
       sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)),
       avg(l_quantity), avg(l_extendedprice), avg(l_discount),
       count(*)
from lineitem
where l_shipdate <= '1998-09-02'
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
"""

LINEITEM_Q6 = """
select sum(l_extendedprice * l_discount)
from lineitem
where l_shipdate >= '1994-01-01' and l_shipdate < '1995-01-01'
  and l_discount between 0.05 and 0.07 and l_quantity < 24
"""

#: string columns ship as Arrow-style dictionary codes: the generator
#: KNOWS its categories, so no per-row encode on the load path
LINEITEM_DICTS = {5: ["A", "N", "R"], 6: ["F", "O"]}


def lineitem_chunks(n: int, seed: int = 7):
    """The synthetic lineitem's column arrays, chunk by chunk: the same
    numpy stream from the same seed as the JAX package's generator, so
    both packages hold byte-identical base blocks.  Decimals are scaled
    by 100; string columns are codes into LINEITEM_DICTS."""
    from .types.values import parse_date

    rng = np.random.default_rng(seed)
    base = parse_date("1992-01-01")
    span = parse_date("1998-12-01") - base
    CHUNK = 1 << 21
    for s0 in range(0, n, CHUNK):
        m = min(CHUNK, n - s0)
        yield [
            rng.integers(1, n // 4 + 2, m, dtype=np.int64),     # orderkey
            rng.integers(100, 5100, m, dtype=np.int64),          # qty (scaled .2)
            rng.integers(90_000, 10_500_001, m, dtype=np.int64),  # price (.2)
            rng.integers(0, 11, m, dtype=np.int64),              # discount (.2)
            rng.integers(0, 9, m, dtype=np.int64),               # tax (.2)
            rng.integers(0, 3, m, dtype=np.int32),               # returnflag
            rng.integers(0, 2, m, dtype=np.int32),               # linestatus
            (base + rng.integers(0, span, m)).astype(np.int32),  # shipdate
        ]


def load_arrays(session, table: str, arrays, dictionaries=None,
                db: str = "test"):
    """Bulk-load plain numpy column arrays (one per column, as the store
    holds them; string columns as codes into `dictionaries[ci]`) into an
    existing table."""
    domain = session.domain
    t = domain.catalog.info_schema().table(db, table)
    store = domain.storage.table(t.id)
    store.bulk_load_arrays(arrays, ts=domain.storage.current_ts(),
                           dictionaries=dictionaries)


def build_lineitem(n: int, regions: int = 8, seed: int = 7):
    """Fresh Domain with `n` synthetic lineitem rows split over `regions`
    regions; returns the session.  Tables of a million rows or more
    start warming the device column cache in the background."""
    from .session import Domain

    domain = Domain()
    s = domain.new_session()
    s.execute(LINEITEM_DDL)
    for arrays in lineitem_chunks(n, seed):
        load_arrays(s, "lineitem", arrays, LINEITEM_DICTS)
    t = domain.catalog.info_schema().table("test", "lineitem")
    store = domain.storage.table(t.id)
    domain.storage.regions.split_even(t.id, regions, store.base_rows)
    from .copr.parallel import prefetch_table

    prefetch_table(domain.storage, t.id)
    return s


def tpch_domain_tables(scale: float = 1.0, seed: int = 1234):
    """The 8-table synthetic TPC-H-shaped domain's arrays, table by table
    in load order: (name, ddl, column arrays).  One numpy stream from
    `seed`, draw for draw the JAX package's `build_tpch_domain`, so the
    load and any reference computed from these arrays see the same
    rows.  String columns are object arrays."""
    from .types.values import parse_date

    n_line = int(8000 * scale)
    n_orders = int(2000 * scale)
    n_cust = int(300 * scale)
    n_part = int(200 * scale)
    n_supp = max(int(40 * scale), 10)
    n_nation = 25

    rng = np.random.default_rng(seed)
    base = parse_date("1992-01-01")
    span = parse_date("1998-12-01") - base

    yield "nation", ("create table nation (n_nationkey bigint, n_name "
                     "varchar(25), n_regionkey bigint)"), [
        np.arange(n_nation, dtype=np.int64),
        np.array([f"NATION{i:02d}" for i in range(n_nation)],
                 dtype=object),
        rng.integers(0, 5, n_nation, dtype=np.int64),
    ]
    yield "region", ("create table region (r_regionkey bigint, r_name "
                     "varchar(25))"), [
        np.arange(5, dtype=np.int64),
        np.array(["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"],
                 dtype=object),
    ]
    scomments = np.array(["quick brown fox", "Customer stuff Complaints",
                          "regular deposits", "silent Customer noise"],
                         dtype=object)
    yield "supplier", ("create table supplier (s_suppkey bigint, s_name "
                       "varchar(25), s_nationkey bigint, s_acctbal "
                       "decimal(12,2), s_comment varchar(40))"), [
        np.arange(n_supp, dtype=np.int64),
        np.array([f"SUPP{i:04d}" for i in range(n_supp)], dtype=object),
        rng.integers(0, n_nation, n_supp, dtype=np.int64),
        np.round(rng.uniform(-999, 9999, n_supp) * 100).astype(np.int64),
        scomments[rng.integers(0, 4, n_supp)],
    ]
    yield "partsupp", ("create table partsupp (ps_partkey bigint, "
                       "ps_suppkey bigint, ps_availqty bigint, "
                       "ps_supplycost decimal(12,2))"), [
        np.repeat(np.arange(n_part, dtype=np.int64), 4),
        rng.integers(0, n_supp, n_part * 4, dtype=np.int64),
        rng.integers(1, 10000, n_part * 4, dtype=np.int64),
        np.round(rng.uniform(1, 1000, n_part * 4) * 100).astype(np.int64),
    ]
    phones = np.array([f"{cc}-555-{i:04d}" for i, cc in zip(
        range(n_cust),
        np.array(["13", "31", "23", "29", "30", "18", "17", "44", "99"])[
            rng.integers(0, 9, n_cust)])], dtype=object)
    yield "customer", ("create table customer (c_custkey bigint, c_name "
                       "varchar(25), c_nationkey bigint, c_mktsegment "
                       "varchar(10), c_acctbal decimal(12,2), c_phone "
                       "varchar(15))"), [
        np.arange(n_cust, dtype=np.int64),
        np.array([f"CUST{i:05d}" for i in range(n_cust)], dtype=object),
        rng.integers(0, n_nation, n_cust, dtype=np.int64),
        np.array(["BUILDING", "MACHINERY", "AUTOMOBILE", "HOUSEHOLD",
                  "FURNITURE"], dtype=object)[rng.integers(0, 5, n_cust)],
        np.round(rng.uniform(-999, 9999, n_cust) * 100).astype(np.int64),
        phones,
    ]
    yield "part", ("create table part (p_partkey bigint, p_name "
                   "varchar(30), p_type varchar(25), p_size bigint, "
                   "p_brand varchar(10))"), [
        np.arange(n_part, dtype=np.int64),
        np.array([f"PART{i:05d}" for i in range(n_part)], dtype=object),
        np.array(["PROMO BRUSHED", "STANDARD POLISHED", "SMALL PLATED",
                  "MEDIUM BURNISHED"], dtype=object)[
            rng.integers(0, 4, n_part)],
        rng.integers(1, 50, n_part, dtype=np.int64),
        np.array([f"Brand#{i}" for i in range(1, 6)], dtype=object)[
            rng.integers(0, 5, n_part)],
    ]
    odate = (base + rng.integers(0, span, n_orders)).astype(np.int32)
    ocomments = np.array(["ordinary request", "special packed requests",
                          "pending special asks",
                          "normal special requests",
                          "quiet commentary"], dtype=object)
    yield "orders", ("create table orders (o_orderkey bigint, o_custkey "
                     "bigint, o_orderstatus varchar(1), o_totalprice "
                     "decimal(15,2), o_orderdate date, o_orderpriority "
                     "varchar(15), o_comment varchar(40))"), [
        np.arange(n_orders, dtype=np.int64),
        # leave the top 60 custkeys order-less so NOT IN subqueries hit
        rng.integers(0, max(n_cust - 60, 1), n_orders, dtype=np.int64),
        np.array(["O", "F", "P"], dtype=object)[
            rng.integers(0, 3, n_orders)],
        np.round(rng.uniform(1000, 400000, n_orders) * 100).astype(
            np.int64),
        odate,
        np.array(["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
                  "5-LOW"], dtype=object)[rng.integers(0, 5, n_orders)],
        ocomments[rng.integers(0, 5, n_orders)],
    ]
    okeys = rng.integers(0, n_orders, n_line, dtype=np.int64)
    sdate = odate[okeys] + rng.integers(1, 120, n_line).astype(np.int32)
    cdate = sdate + rng.integers(-30, 30, n_line).astype(np.int32)
    rdate = sdate + rng.integers(1, 30, n_line).astype(np.int32)
    yield "lineitem", ("create table lineitem (l_orderkey bigint, "
                       "l_partkey bigint, l_suppkey bigint, l_quantity "
                       "decimal(15,2), l_extendedprice decimal(15,2), "
                       "l_discount decimal(15,2), l_tax decimal(15,2), "
                       "l_returnflag varchar(1), l_linestatus varchar(1), "
                       "l_shipdate date, l_commitdate date, "
                       "l_receiptdate date, l_shipmode varchar(10))"), [
        okeys,
        rng.integers(0, n_part, n_line, dtype=np.int64),
        rng.integers(0, n_supp, n_line, dtype=np.int64),
        rng.integers(100, 5100, n_line, dtype=np.int64),  # scaled .2
        np.round(rng.uniform(900, 105000, n_line) * 100).astype(np.int64),
        np.round(rng.uniform(0.0, 0.1, n_line) * 100).astype(np.int64),
        np.round(rng.uniform(0.0, 0.08, n_line) * 100).astype(np.int64),
        np.array(["A", "N", "R"], dtype=object)[
            rng.integers(0, 3, n_line)],
        np.array(["O", "F"], dtype=object)[rng.integers(0, 2, n_line)],
        sdate,
        cdate,
        rdate,
        np.array(["AIR", "MAIL", "SHIP", "TRUCK", "RAIL", "REG AIR",
                  "FOB"], dtype=object)[rng.integers(0, 7, n_line)],
    ]


def build_tpch_domain(scale: float = 1.0, seed: int = 1234,
                      regions: int = 4):
    """Full 8-table synthetic TPC-H-shaped domain (the golden-suite
    recipe, shared by the tests and the chip smoke run so they can never
    drift apart on schema or distribution): `tpch_domain_tables` loaded
    table by table, each split over `regions` regions.  Returns the
    session."""
    from .session import Domain

    d = Domain()
    s = d.new_session()
    for name, ddl, arrays in tpch_domain_tables(scale, seed):
        s.execute(ddl)
        t = d.catalog.info_schema().table("test", name)
        store = d.storage.table(t.id)
        store.bulk_load_arrays(arrays, ts=d.storage.current_ts())
        d.storage.regions.split_even(t.id, regions, store.base_rows)
    for t in ("lineitem", "orders", "customer"):
        s.execute(f"analyze table {t}")
    return s


#: how many base relations each query's FROM joins (join-tree depth:
#: the `tpch_matrix` receipt reports the fused fraction per depth)
TPCH_N_TABLES = {
    "q1": 1, "q2": 5, "q3": 3, "q4": 2, "q5": 5, "q6": 1, "q7": 6,
    "q8": 8, "q9": 6, "q10": 3, "q11": 3, "q12": 2, "q13": 2, "q14": 2,
    "q15": 2, "q16": 3, "q17": 2, "q18": 4, "q19": 2, "q20": 4,
    "q21": 6, "q22": 2,
}


# the canonical Q3-shaped query over build_q3_tables' pair (shared by the
# bench, the multichip dryrun, and the multihost worker so they always
# exercise the same plan shape)
Q3_SQL = (
    "select l_orderkey, o_orderdate, o_shippriority,"
    " sum(l_extendedprice * (1 - l_discount)) as rev"
    " from lineitem, orders where l_orderkey = o_orderkey"
    " and o_orderdate < '1995-03-15' and l_shipdate > '1995-03-15'"
    " group by l_orderkey, o_orderdate, o_shippriority"
    " order by rev desc, l_orderkey limit 10"
)


def q3_tables(n_li: int, n_orders: int, seed: int = 11):
    """The Q3 pair's arrays from one numpy stream, draw for draw the JAX
    package's `build_q3_tables`: ("orders", columns) first, then
    ("lineitem", columns) chunks of at most 2**21 rows.  Every lineitem
    row's l_orderkey matches one order."""
    from .types.values import parse_date

    rng = np.random.default_rng(seed)
    base = parse_date("1995-01-01")
    yield "orders", [
        np.arange(n_orders, dtype=np.int64),
        (base + rng.integers(-400, 400, n_orders)).astype(np.int64),
        rng.integers(0, 5, n_orders),
    ]
    CHUNK = 1 << 21
    for s0 in range(0, n_li, CHUNK):
        m = min(CHUNK, n_li - s0)
        yield "lineitem", [
            rng.integers(0, n_orders, m),
            rng.integers(90_000, 10_500_001, m),
            rng.integers(0, 11, m),
            (base + rng.integers(-300, 300, m)).astype(np.int64),
        ]


def build_q3_tables(n_li: int, n_orders: int, regions: int = 8,
                    seed: int = 11):
    """Q3-shaped pair: orders (PK o_orderkey, the broadcast build side)
    joined by a lineitem fact table — the device lookup-join benchmark
    shape (reference executor/join.go role under TPC-H Q3).  The arrays
    are `q3_tables`'; lineitem splits over `regions` regions."""
    from .session import Domain

    domain = Domain()
    s = domain.new_session()
    s.execute("create table orders (o_orderkey bigint primary key,"
              " o_orderdate date, o_shippriority bigint)")
    s.execute("create table lineitem (l_orderkey bigint,"
              " l_extendedprice decimal(15,2), l_discount decimal(15,2),"
              " l_shipdate date)")
    for name, arrays in q3_tables(n_li, n_orders, seed):
        t = domain.catalog.info_schema().table("test", name)
        domain.storage.table(t.id).bulk_load_arrays(
            arrays, ts=domain.storage.current_ts())
    t_l = domain.catalog.info_schema().table("test", "lineitem")
    domain.storage.regions.split_even(
        t_l.id, regions, domain.storage.table(t_l.id).base_rows)
    s.execute("analyze table orders")
    s.execute("analyze table lineitem")
    return s


#: the 22-query TPC-H golden corpus over build_tpch_domain's
#: schema (tests assert engine parity; the bench receipt classifies
#: each query's residency)
TPCH_QUERIES = {
    "q1": """
select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
       sum(l_extendedprice) as sum_base_price,
       sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
       sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
       avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
       avg(l_discount) as avg_disc, count(*) as count_order
from lineitem
where l_shipdate <= date '1998-09-02'
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus""",
    "q3": """
select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
       o_orderdate
from customer, orders, lineitem
where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
  and l_orderkey = o_orderkey and o_orderdate < date '1995-03-15'
  and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate
order by revenue desc, o_orderkey
limit 10""",
    "q5": """
select n_name, sum(l_extendedprice * (1 - l_discount)) as revenue
from customer, orders, lineitem, supplier, nation
where c_custkey = o_custkey and l_orderkey = o_orderkey
  and l_suppkey = s_suppkey and c_nationkey = s_nationkey
  and s_nationkey = n_nationkey
  and o_orderdate >= date '1994-01-01' and o_orderdate < date '1995-01-01'
group by n_name order by revenue desc""",
    "q6": """
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '1994-01-01' and l_shipdate < date '1995-01-01'
  and l_discount between 0.05 and 0.07 and l_quantity < 24""",
    "q10": """
select c_custkey, c_name, sum(l_extendedprice * (1 - l_discount)) as revenue
from customer, orders, lineitem
where c_custkey = o_custkey and l_orderkey = o_orderkey
  and o_orderdate >= date '1993-10-01' and o_orderdate < date '1994-01-01'
  and l_returnflag = 'R'
group by c_custkey, c_name
order by revenue desc, c_custkey limit 20""",
    "q12": """
select l_shipmode,
       sum(case when o_orderpriority = '1-URGENT'
                  or o_orderpriority = '2-HIGH' then 1 else 0 end)
         as high_line_count,
       sum(case when o_orderpriority <> '1-URGENT'
                 and o_orderpriority <> '2-HIGH' then 1 else 0 end)
         as low_line_count
from orders join lineitem on o_orderkey = l_orderkey
where l_shipmode in ('MAIL', 'SHIP')
  and l_commitdate < l_receiptdate and l_shipdate < l_commitdate
  and l_receiptdate >= date '1994-01-01'
  and l_receiptdate < date '1995-01-01'
group by l_shipmode order by l_shipmode""",
    "q13": """
select c_count, count(*) as custdist from (
  select c_custkey, count(o_orderkey) as c_count
  from customer left join orders on c_custkey = o_custkey
      and o_comment not like '%special%requests%'
  group by c_custkey
) c_orders
group by c_count
order by custdist desc, c_count desc limit 10""",
    "q14": """
select 100.00 * sum(case when p_type like 'PROMO%%'
                         then l_extendedprice * (1 - l_discount)
                         else 0 end) / sum(l_extendedprice * (1 - l_discount))
       as promo_revenue
from lineitem, part
where l_partkey = p_partkey
  and l_shipdate >= date '1995-09-01' and l_shipdate < date '1995-10-01'""",
    "q18": """
select c_custkey, o_orderkey, o_totalprice, sum(l_quantity)
from customer, orders, lineitem
where o_orderkey in (
    select l_orderkey from lineitem group by l_orderkey
    having sum(l_quantity) > 100
  )
  and c_custkey = o_custkey and o_orderkey = l_orderkey
group by c_custkey, o_orderkey, o_totalprice
order by o_totalprice desc, o_orderkey limit 10""",
    "q19": """
select sum(l_extendedprice * (1 - l_discount)) as revenue
from lineitem, part
where p_partkey = l_partkey
  and ((p_size >= 1 and p_size <= 15 and l_quantity >= 1)
       or (p_size >= 16 and l_quantity >= 10))
  and l_shipdate >= date '1994-01-01'""",
    "q4": """
select o_orderpriority, count(*) as order_count
from orders
where o_orderdate >= date '1993-07-01' and o_orderdate < date '1993-10-01'
  and exists (select 1 from lineitem
              where l_orderkey = o_orderkey and l_shipdate > o_orderdate)
group by o_orderpriority order by o_orderpriority""",
    "q17": """
select sum(l_extendedprice) / 7.0 as avg_yearly
from lineitem, part
where p_partkey = l_partkey and p_type = 'PROMO BRUSHED'
  and l_quantity < (select 0.2 * avg(l_quantity) from lineitem
                    where l_partkey = p_partkey)""",
    "q2": """
select s_acctbal, s_name, n_name, p_partkey, p_name
from part, supplier, partsupp, nation, region
where p_partkey = ps_partkey and s_suppkey = ps_suppkey
  and p_size < 25 and p_type like '%%POLISHED%%'
  and s_nationkey = n_nationkey and n_regionkey = r_regionkey
  and r_name = 'EUROPE'
  and ps_supplycost = (
    select min(ps_supplycost)
    from partsupp, supplier, nation, region
    where p_partkey = ps_partkey and s_suppkey = ps_suppkey
      and s_nationkey = n_nationkey and n_regionkey = r_regionkey
      and r_name = 'EUROPE')
order by s_acctbal desc, n_name, s_name, p_partkey limit 100""",
    "q7": """
select supp_nation, cust_nation, l_year, sum(volume) as revenue
from (
  select n1.n_name as supp_nation, n2.n_name as cust_nation,
         year(l_shipdate) as l_year,
         l_extendedprice * (1 - l_discount) as volume
  from supplier, lineitem, orders, customer, nation n1, nation n2
  where s_suppkey = l_suppkey and o_orderkey = l_orderkey
    and c_custkey = o_custkey and s_nationkey = n1.n_nationkey
    and c_nationkey = n2.n_nationkey
    and ((n1.n_name = 'NATION01' and n2.n_name = 'NATION02')
         or (n1.n_name = 'NATION02' and n2.n_name = 'NATION01'))
    and l_shipdate between date '1995-01-01' and date '1996-12-31'
) shipping
group by supp_nation, cust_nation, l_year
order by supp_nation, cust_nation, l_year""",
    "q8": """
select o_year,
       sum(case when nation = 'NATION02' then volume else 0 end)
         / sum(volume) as mkt_share
from (
  select year(o_orderdate) as o_year,
         l_extendedprice * (1 - l_discount) as volume,
         n2.n_name as nation
  from part, supplier, lineitem, orders, customer, nation n1, nation n2,
       region
  where p_partkey = l_partkey and s_suppkey = l_suppkey
    and l_orderkey = o_orderkey and o_custkey = c_custkey
    and c_nationkey = n1.n_nationkey and n1.n_regionkey = r_regionkey
    and r_name = 'AMERICA' and s_nationkey = n2.n_nationkey
    and o_orderdate between date '1995-01-01' and date '1996-12-31'
    and p_type = 'STANDARD POLISHED'
) all_nations
group by o_year order by o_year""",
    "q9": """
select nation, o_year, sum(amount) as sum_profit
from (
  select n_name as nation, year(o_orderdate) as o_year,
         l_extendedprice * (1 - l_discount)
           - ps_supplycost * l_quantity as amount
  from part, supplier, lineitem, partsupp, orders, nation
  where s_suppkey = l_suppkey and ps_suppkey = l_suppkey
    and ps_partkey = l_partkey and p_partkey = l_partkey
    and o_orderkey = l_orderkey and s_nationkey = n_nationkey
    and p_name like '%%1%%'
) profit
group by nation, o_year
order by nation, o_year desc limit 30""",
    "q11": """
select ps_partkey, sum(ps_supplycost * ps_availqty) as value
from partsupp, supplier, nation
where ps_suppkey = s_suppkey and s_nationkey = n_nationkey
  and n_name = 'NATION16'
group by ps_partkey
having sum(ps_supplycost * ps_availqty) > (
  select sum(ps_supplycost * ps_availqty) * 0.02
  from partsupp, supplier, nation
  where ps_suppkey = s_suppkey and s_nationkey = n_nationkey
    and n_name = 'NATION16')
order by value desc""",
    "q15": """
select s_suppkey, s_name, total_revenue
from supplier, (
  select l_suppkey as supplier_no,
         sum(l_extendedprice * (1 - l_discount)) as total_revenue
  from lineitem
  where l_shipdate >= date '1996-01-01' and l_shipdate < date '1996-04-01'
  group by l_suppkey) revenue
where s_suppkey = supplier_no
  and total_revenue = (
    select max(total_revenue) from (
      select l_suppkey as supplier_no,
             sum(l_extendedprice * (1 - l_discount)) as total_revenue
      from lineitem
      where l_shipdate >= date '1996-01-01'
        and l_shipdate < date '1996-04-01'
      group by l_suppkey) r)
order by s_suppkey""",
    "q16": """
select p_brand, p_type, p_size, count(distinct ps_suppkey) as supplier_cnt
from partsupp, part
where p_partkey = ps_partkey and p_brand <> 'Brand#1'
  and p_type not like 'SMALL%%'
  and p_size in (1, 5, 10, 15, 20, 25, 30, 35)
  and ps_suppkey not in (
    select s_suppkey from supplier
    where s_comment like '%%Customer%%Complaints%%')
group by p_brand, p_type, p_size
order by supplier_cnt desc, p_brand, p_type, p_size limit 20""",
    "q20": """
select s_name, s_nationkey
from supplier, nation
where s_suppkey in (
    select ps_suppkey from partsupp
    where ps_partkey in (select p_partkey from part
                         where p_name like 'PART000%%')
      and ps_availqty > (
        select 0.5 * sum(l_quantity) from lineitem
        where l_partkey = ps_partkey and l_suppkey = ps_suppkey
          and l_shipdate >= date '1994-01-01'
          and l_shipdate < date '1995-01-01'))
  and s_nationkey = n_nationkey and n_name = 'NATION03'
order by s_name""",
    "q21": """
select s_name, count(*) as numwait
from supplier, lineitem l1, orders, nation
where s_suppkey = l1.l_suppkey and o_orderkey = l1.l_orderkey
  and o_orderstatus = 'F' and l1.l_receiptdate > l1.l_commitdate
  and exists (select 1 from lineitem l2
              where l2.l_orderkey = l1.l_orderkey
                and l2.l_suppkey <> l1.l_suppkey)
  and not exists (select 1 from lineitem l3
                  where l3.l_orderkey = l1.l_orderkey
                    and l3.l_suppkey <> l1.l_suppkey
                    and l3.l_receiptdate > l3.l_commitdate)
  and s_nationkey = n_nationkey and n_name = 'NATION05'
group by s_name
order by numwait desc, s_name limit 100""",
    "q22": """
select cntrycode, count(*) as numcust, sum(c_acctbal) as totacctbal
from (
  select substring(c_phone, 1, 2) as cntrycode, c_acctbal
  from customer
  where substring(c_phone, 1, 2) in ('13', '31', '23', '29', '30', '18',
                                     '17')
    and c_acctbal > (
      select avg(c_acctbal) from customer
      where c_acctbal > 0.00
        and substring(c_phone, 1, 2) in ('13', '31', '23', '29', '30',
                                         '18', '17'))
    and not exists (select 1 from orders where o_custkey = c_custkey)
) custsale
group by cntrycode order by cntrycode""",
}
