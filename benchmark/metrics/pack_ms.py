"""The 2-bit pack of a pass's codes on the host (the engine's
``enqueue.pack`` spans, ``pack2bit_host`` under ONT on one sub-index), the
mean over the window's passes in ms."""

from benchmark import program_spans


def read(rec):
    return program_spans.per_pass_ms(rec, "enqueue.pack")
