"""Padding rows (``ids == -1``) over the row slots of the super-batches
run in the window (the engine's ``pad_rows`` and ``row_slots`` pass
counters), in percent."""

from benchmark import program_spans


def read(rec):
    sums = program_spans.counters(rec, "pad_rows", "row_slots")
    if sums is None or not sums[1]:
        return None
    return 100.0 * sums[0] / sums[1]
