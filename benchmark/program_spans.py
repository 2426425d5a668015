"""The program's own spans and counters (``lrge_tpu_torch.spans``), read
by the per-layer metrics: the window's pass records, held to the
harness's passes, and the set-up record.  A program without that module
reads as nothing (None), with the reason in the run's notes."""

from __future__ import annotations


def _spans(rec):
    try:
        from lrge_tpu_torch import spans
    except ImportError as err:
        rec.notes.append(f"program spans: none to read ({err})")
        return None
    return spans


def window(rec):
    """The pass records of the window's passes (the program's last
    ``len(rec.passes)``), or None unless record ``i``'s ``enqueue`` span
    lasted exactly ``rec.passes[i].phases["enqueue"]``."""
    spans = _spans(rec)
    if spans is None or not rec.passes:
        return None
    records = list(spans.passes)[-len(rec.passes):]
    if len(records) != len(rec.passes):
        rec.notes.append(f"program spans: {len(records)} pass records for {len(rec.passes)} passes")
        return None
    for i, (r, p) in enumerate(zip(records, rec.passes)):
        enqueue = [s.end - s.start for s in r.spans if s.name == "enqueue"]
        if enqueue != [p.phases.get("enqueue")]:
            rec.notes.append(
                f"program spans: pass record {r.number} does not line up with pass {i} of the window "
                f"(enqueue {enqueue} against {p.phases.get('enqueue')})"
            )
            return None
    return records


def per_pass_ms(rec, name: str):
    """The ``name`` spans' seconds a pass, the mean over the window's
    passes in ms: 0 where the passes ran no such stage (say, no 2-bit
    pack on a multi-sub index), which the notes then say."""
    records = window(rec)
    if records is None:
        return None
    if not any(s.name == name for r in records for s in r.spans):
        rec.notes.append(f"program spans: no {name} span in the window's passes")
    return 1e3 * sum(s.end - s.start for r in records for s in r.spans if s.name == name) / len(records)


def counters(rec, *names):
    """The window's sums of the pass counters ``names``, or None."""
    records = window(rec)
    if records is None:
        return None
    return [sum(r.counters.get(n, 0) for r in records) for n in names]


def setup_s(rec, name: str):
    """Seconds of the ``name`` spans in the set-up record, or None."""
    spans = _spans(rec)
    if spans is None:
        return None
    found = [s.end - s.start for s in spans.setup.spans if s.name == name]
    if not found:
        rec.notes.append(f"program spans: no {name} span in the set-up")
        return None
    return sum(found)
