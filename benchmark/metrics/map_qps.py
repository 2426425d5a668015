"""Query reads counted and estimated per second: the reads of every
pass of the window over the window's whole time."""


def read(rec):
    return rec.n_queries * len(rec.passes) / rec.window_s
