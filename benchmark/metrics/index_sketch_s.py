"""Seconds of the targets' sketch in ``build_index`` (the ``index.sketch``
span of the set-up)."""

from benchmark import program_spans


def read(rec):
    return program_spans.setup_s(rec, "index.sketch")
