"""The engine's ``retry`` stage a pass (``last_phases``): the exact host
recount of the rows the device cannot guarantee, and the wait for the
host thread's rows; the mean over the window's passes in ms."""


def read(rec):
    return 1e3 * sum(p.phases["retry"] for p in rec.passes) / len(rec.passes)
