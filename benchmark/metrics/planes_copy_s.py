"""Seconds of the index planes' moves to the card (the ``planes.copy``
spans of the set-up, after their host build)."""

from benchmark import program_spans


def read(rec):
    return program_spans.setup_s(rec, "planes.copy")
