"""Statement shapes, found by name: `<name>.json` holds the SQL
template, its parameter samplers and the columns it reads;
`<name>.py` holds `reference(tables, params, exact=True)`, the plain
torch computation of its rows as wire text (`exact=False`: the control,
the same arithmetic with decimals as doubles)."""
