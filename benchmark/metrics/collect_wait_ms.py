"""The host blocked on the card in a pass (the engine's ``collect.wait``
spans: each super-batch's copy of its results to the host), the mean over
the window's passes in ms."""

from benchmark import program_spans


def read(rec):
    return program_spans.per_pass_ms(rec, "collect.wait")
