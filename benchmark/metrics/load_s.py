"""Seconds of the program's native builds or loads in the set-up (the
``load`` spans: the host extension at import, the chain DP's library at
first use)."""

from benchmark import program_spans


def read(rec):
    return program_spans.setup_s(rec, "load")
