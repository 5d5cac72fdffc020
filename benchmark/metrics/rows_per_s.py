"""Base-table rows read by the statements answered inside the window
(each statement counts every row of each table it reads), over the
window's length."""


def read(w):
    return sum(s["rows_read"] for s in w.in_window) / w.seconds
