"""Seconds of the host side of the index planes' build (the
``planes.host`` spans of the set-up: the sub-index plan, pruning, sorting
and the dictionary, before the copies to the card)."""

from benchmark import program_spans


def read(rec):
    return program_spans.setup_s(rec, "planes.host")
