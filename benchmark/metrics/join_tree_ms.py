"""Host-clock time a statement spends inside the program's `mpp.tree`
spans (the MPP join tree: its rungs' dispatches through the readback of
the grouped partials), summed over the statement traces that finished
in the window, over their number."""

NAME = "mpp.tree"


def read(w):
    if not w.n_traces:
        return None
    return sum(s.end - s.start for s in w.spans
               if s.name == NAME) / 1e6 / w.n_traces
