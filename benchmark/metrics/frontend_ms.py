"""Host time of the SQL front end a statement: the self time of the
program's `parse` and `plan` spans, summed over the statement traces
that finished in the window, over their number."""

NAMES = ("parse", "plan")


def read(w):
    if not w.n_traces:
        return None
    return sum(s.self_ns for s in w.spans if s.name in NAMES) / 1e6 / w.n_traces
