"""PacBio's host sketch of a pass's queries (the engine's
``enqueue.pb_sketch`` spans, ``sketch_seqs_native`` in ``_pb_planes``), the
mean over the window's passes in ms."""

from benchmark import program_spans


def read(rec):
    return program_spans.per_pass_ms(rec, "enqueue.pb_sketch")
