"""The host batching of a pass (the engine's ``enqueue.batch`` spans:
``super_batches``' ``make_batches``, the padding into codes, lengths
and ids, the dual and self ranks), the mean over the window's passes in
ms."""

from benchmark import program_spans


def read(rec):
    return program_spans.per_pass_ms(rec, "enqueue.batch")
