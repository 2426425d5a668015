"""The engine's ``enqueue`` stage a pass (``last_phases``), the mean
over the window's passes in ms: the host batching of the super-batches
and, under PacBio, the host sketch of the queries."""


def read(rec):
    return 1e3 * sum(p.phases["enqueue"] for p in rec.passes) / len(rec.passes)
