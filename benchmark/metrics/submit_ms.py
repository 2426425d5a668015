"""The submission of a pass's super-batch programs (``SuperBatchProgram.
run``'s ``enqueue.submit`` spans: pinning, the copies to the card, the
replays, the output clones), the mean over the window's passes in ms."""

from benchmark import program_spans


def read(rec):
    return program_spans.per_pass_ms(rec, "enqueue.submit")
