"""Set-up: from the run's start to the end of the warm-up (the port on
the card, the tables generated and bulk-loaded, split and analyzed, the
server up, the cell's statement shapes warmed up)."""


def read(w):
    return w.setup_s
