"""The host triage of a pass's device results (the engine's
``collect.triage`` spans: ``triage_flags`` and the scatter of counts and
pairs), the mean over the window's passes in ms."""

from benchmark import program_spans


def read(rec):
    return program_spans.per_pass_ms(rec, "collect.triage")
