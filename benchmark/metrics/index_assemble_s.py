"""Seconds of the index's assembly in ``build_index`` (the
``index.assemble`` span of the set-up: the postings' concatenation,
their sort by hash and the occurrence counts, after the targets'
sketch)."""

from benchmark import program_spans


def read(rec):
    return program_spans.setup_s(rec, "index.assemble")
