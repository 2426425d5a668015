"""PacBio's per-row fill of the lookup planes from the host sketch (the
engine's ``enqueue.pb_fill`` spans in ``_pb_planes``), the mean over the
window's passes in ms."""

from benchmark import program_spans


def read(rec):
    return program_spans.per_pass_ms(rec, "enqueue.pb_fill")
