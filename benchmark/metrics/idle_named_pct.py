"""The share of the traced window's idle device time that the trace
names by a host stage or operation, in percent: all of it but what falls
under a span that only encloses stages (the harness's
``bench.count_batch``, the program's ``count_batch``, ``enqueue``,
``super_batch``, ``collect`` and ``retry`` outside their children),
under the window's span alone (``host``) or among the short gaps lumped
together."""

from benchmark import trace

ENCLOSING = (trace.SPAN_PREFIX + "count_batch",) + tuple(
    "lrge." + name for name in ("count_batch", "enqueue", "super_batch", "collect", "retry")
)


def read(rec):
    if rec.trace is None:
        return None
    idle = rec.trace["idle"]
    total = sum(idle.values())
    if total <= 0:
        return None
    unnamed = sum(v for k, v in idle.items() if k in ENCLOSING or k == "host" or k.startswith("gaps under"))
    return 100.0 * (total - unnamed) / total
