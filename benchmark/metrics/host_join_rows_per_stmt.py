"""Rows the program's host join executors emitted (hash, index-lookup
and merge joins, the MPP engines' host rungs and the agg-peel tail:
the counter `host_join_rows_total`), moved over the traced window, over
the statements answered in it.  0 while every join of the cell stays on
the card; nothing where the program keeps no such counter."""


def read(w):
    moved = w.counters.get("host_join_rows_total")
    if moved is None or not w.stmts:
        return None
    return moved / len(w.stmts)
